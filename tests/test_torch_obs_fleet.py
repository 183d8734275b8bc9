"""The port's fleet observability (consensus_specs_tpu_torch/obs/: the
occupancy ledger, the flight recorder with its fault dump and endpoint,
SLO burn rates with /healthz, and the exposition plane) against the JAX
package's, on the CPU: each case of tests/test_obs_fleet.py runs on both
packages as one test parametrised over the package, against crypto-free
backends (the port's services with ``device="cpu"``).
"""
import json
import os
import threading
import time
import urllib.error
import urllib.request

import pytest
import torch

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu import serve as jserve  # noqa: E402
from consensus_specs_tpu.obs import devices as jdevices  # noqa: E402
from consensus_specs_tpu.obs import exposition as jexpo  # noqa: E402
from consensus_specs_tpu.obs import flight as jflight  # noqa: E402
from consensus_specs_tpu.obs import registry as jregistry  # noqa: E402
from consensus_specs_tpu.obs import slo as jslo  # noqa: E402
from consensus_specs_tpu.obs import tracing as jtracing  # noqa: E402
from consensus_specs_tpu.ops import profiling as jprofiling  # noqa: E402
from consensus_specs_tpu.serve import load as jload  # noqa: E402
from consensus_specs_tpu.utils import bls as jbls  # noqa: E402
from consensus_specs_tpu_torch import serve as tserve  # noqa: E402
from consensus_specs_tpu_torch.obs import devices as tdevices  # noqa: E402
from consensus_specs_tpu_torch.obs import exposition as texpo  # noqa: E402
from consensus_specs_tpu_torch.obs import flight as tflight  # noqa: E402
from consensus_specs_tpu_torch.obs import registry as tregistry  # noqa: E402
from consensus_specs_tpu_torch.obs import slo as tslo  # noqa: E402
from consensus_specs_tpu_torch.obs import tracing as ttracing  # noqa: E402
from consensus_specs_tpu_torch.ops import profiling as tprofiling  # noqa: E402
from consensus_specs_tpu_torch.serve import load as tload  # noqa: E402
from consensus_specs_tpu_torch.utils import bls as tbls  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

PK = b"\x01" * 48
PKGS = ("jax", "torch")


class Pkg:
    def __init__(self, name):
        jax = name == "jax"
        self.name = name
        self.serve = jserve if jax else tserve
        self.devices = jdevices if jax else tdevices
        self.expo = jexpo if jax else texpo
        self.flight = jflight if jax else tflight
        self.registry = jregistry if jax else tregistry
        self.slo = jslo if jax else tslo
        self.tracing = jtracing if jax else ttracing
        self.profiling = jprofiling if jax else tprofiling
        self.load = jload if jax else tload
        self.bls = jbls if jax else tbls
        self.kw = {} if jax else {"device": "cpu"}

    def reset(self):
        self.profiling.reset()
        self.tracing.reset_global()
        self.devices.reset_global()
        self.flight.reset_global()
        self.slo.reset_global()

    def svc(self, backend, **kw):
        kw.setdefault("bucket_fn", lambda k: 8)
        kw.setdefault("oracle", _Oracle(self.load.BAD_SIGNATURE))
        return self.serve.VerificationService(backend=backend,
                                              **{**self.kw, **kw})

    def rlc_backend(self):
        bad = self.load.BAD_SIGNATURE

        class RlcVerdictBackend(self.load.VerdictBackend):
            """VerdictBackend + the RLC entry point, so the whole ladder
            (RLC -> per-group -> oracle) runs on crypto-free verdicts."""

            def batch_verify_rlc(self, items, mesh=None, rng=None,
                                 device=None):
                self.calls += 1
                return [bytes(sig) != bad for _kind, _pks, _msgs, sig in items]

        return RlcVerdictBackend()


class _Oracle:
    def __init__(self, bad):
        self.bad = bad

    def verify_one(self, pending):
        return bytes(pending.signature) != self.bad


@pytest.fixture(params=PKGS)
def pkg(request, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_TRACE", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "0")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_DEVICES", "0")
    monkeypatch.delenv("CONSENSUS_SPECS_TPU_SLO", raising=False)
    p = Pkg(request.param)
    p.reset()
    was = p.bls.bls_active
    p.bls.bls_active = True
    yield p
    p.bls.bls_active = was
    p.reset()


# -- device occupancy ledger -------------------------------------------------


def test_ledger_accumulates_busy_time_per_lane(pkg):
    t = {"now": 100.0}
    led = pkg.devices.DeviceLedger(clock=lambda: t["now"])
    led.note_busy(0, 100.0, 100.5, label="vm")
    led.note_busy(0, 100.5, 100.75, label="vm")
    led.note_busy(pkg.devices.HOST_LANE, 100.0, 100.25, label="prep")
    t["now"] = 101.0
    util = led.utilization()
    assert util["0"] == pytest.approx(0.75)
    assert util["host"] == pytest.approx(0.25)
    snap = led.snapshot()
    assert snap["lanes"]["0"]["events"] == 2
    assert snap["lanes"]["0"]["busy_s"] == pytest.approx(0.75)
    assert snap["lanes"]["host"]["utilization"] == pytest.approx(0.25)
    tl = led.timeline()
    assert ("0", "vm", 100.0, 100.5) in tl
    assert ("host", "prep", 100.0, 100.25) in tl


def test_ledger_note_execution_maps_a_run_to_its_lane(pkg):
    """The JAX ledger puts a meshless run on device 0; the port's puts a
    run on its torch device's lane (``cpu`` for the plain path)."""
    device, lane = ((None, "0") if pkg.name == "jax"
                    else (torch.device("cpu"), "cpu"))
    led = pkg.devices.DeviceLedger(clock=lambda: 0.0)
    led.note_execution(device, 1.0, 0.5, label="vm[steps=64]")
    lanes = led.snapshot()["lanes"]
    assert list(lanes) == [lane]
    assert (lanes[lane]["busy_s"], lanes[lane]["events"]) == (0.5, 1)
    assert led.timeline() == [(lane, "vm[steps=64]", 1.0, 1.5)]


def test_ledger_gauges_use_registered_families(pkg):
    led = pkg.devices.DeviceLedger()
    led.note_busy(0, 0.0, 0.1)
    led.note_busy(pkg.devices.HOST_LANE, 0.0, 0.1)
    led.export_gauges()
    summ = pkg.profiling.summary()
    assert summ["device.count"] == {"gauge": 2.0}
    assert "device[0]" in summ and "device[host]" in summ
    for label in ("device.count", "device.busy_s", "device[0]",
                  "device[host]"):
        assert pkg.registry.known(label), label


def test_serve_prep_stage_feeds_the_host_lane(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_DEVICES", "1")
    pkg.devices.reset_global()
    with pkg.svc(pkg.rlc_backend(), max_batch=4, max_wait_ms=5) as svc:
        futs = [svc.submit("fast_aggregate", [PK], b"m%d" % i, b"ok")
                for i in range(8)]
        assert all(f.result(timeout=10) for f in futs)
    snap = pkg.devices.global_ledger().snapshot()
    assert "host" in snap["lanes"] and snap["lanes"]["host"]["events"] >= 1


def test_disabled_ledger_is_a_none_check(pkg):
    assert pkg.devices.maybe_ledger() is None
    with pkg.svc(pkg.rlc_backend(), max_batch=1, max_wait_ms=0) as svc:
        assert svc._devices is None
        assert svc.submit("fast_aggregate", [PK], b"m", b"ok").result(
            timeout=10) is True


def test_occupancy_lane_rides_the_chrome_trace(pkg, monkeypatch, tmp_path):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_DEVICES", "1")
    pkg.devices.reset_global()
    tracer = pkg.tracing.global_tracer()
    led = pkg.devices.global_ledger()
    led.note_busy(0, tracer._t0 + 0.001, tracer._t0 + 0.002, label="vm")
    led.note_busy(pkg.devices.HOST_LANE, tracer._t0, tracer._t0 + 0.001,
                  label="prep")
    path = pkg.tracing.dump_trace(str(tmp_path / "trace.json"))
    with open(path) as fh:
        doc = json.load(fh)
    lane = [e for e in doc["traceEvents"] if e.get("pid") == 3]
    assert any(e["ph"] == "M" and e["args"].get("name") == "device-occupancy"
               for e in lane)
    xs = [e for e in lane if e["ph"] == "X"]
    assert {e["args"]["lane"] for e in xs} == {"0", "host"}
    assert all(e["ts"] >= 0 and e["dur"] > 0 for e in xs)


# -- flight recorder ----------------------------------------------------------


def test_flight_ring_is_bounded_and_counts_drops(pkg):
    rec = pkg.flight.FlightRecorder(capacity=4, clock=lambda: 1.0)
    for i in range(10):
        rec.note("serve", "flush", items=i)
    events = rec.events()
    assert [e["data"]["items"] for e in events] == [6, 7, 8, 9]
    c = rec.counters()
    assert c["events"] == 10 and c["dropped"] == 6 and c["retained"] == 4


def test_flight_dump_jsonl_roundtrip(pkg, tmp_path):
    rec = pkg.flight.FlightRecorder(capacity=16, clock=lambda: 2.5)
    rec.note("chain", "on_block", slot=7, root="ab" * 8)
    rec.note("vm", "assembly_stall", key="hard_part[k=0,fold=32]",
             seconds=6.2)
    path = rec.dump(str(tmp_path / "flight.jsonl"), reason="test")
    lines = [json.loads(ln) for ln in open(path).read().splitlines()]
    assert lines[0] == {"flight": "v1", "reason": "test", "events": 2,
                        "retained": 2, "dropped": 0}
    assert lines[1]["plane"] == "chain" and lines[1]["kind"] == "on_block"
    assert lines[1]["data"]["slot"] == 7 and lines[1]["seq"] == 1
    assert lines[2]["data"]["key"] == "hard_part[k=0,fold=32]"
    rec.export_gauges()
    summ = pkg.profiling.summary()
    assert summ["flight.events"] == {"gauge": 2.0}
    assert summ["flight.dumps"] == {"gauge": 1.0}


def test_flight_off_path_is_a_none_check_and_overhead_is_bounded(pkg):
    with pkg.svc(pkg.rlc_backend(), max_batch=1, max_wait_ms=0) as svc:
        assert svc._flight is None
    assert pkg.flight.maybe_recorder() is None
    n = 20_000
    rec = pkg.flight.FlightRecorder(capacity=4096)
    t0 = time.perf_counter()
    for i in range(n):
        rec.note("serve", "flush", items=i)
    per_event = (time.perf_counter() - t0) / n
    # deque-append scale: microseconds, not milliseconds
    assert per_event < 1e-3, f"flight note cost {per_event * 1e6:.1f}us"
    assert rec.counters()["events"] == n


def test_flight_ring_env_tolerates_malformed_values(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    for bad in ("4k", "", "-5"):
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT_RING", bad)
        pkg.flight.reset_global()
        rec = pkg.flight.maybe_recorder()
        assert rec is not None
        assert rec._ring.maxlen == pkg.flight.DEFAULT_RING
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT_RING", "16")
    pkg.flight.reset_global()
    assert pkg.flight.maybe_recorder()._ring.maxlen == 16


def test_flightdump_endpoint_serves_jsonl_and_404s_when_off(pkg,
                                                            monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    pkg.flight.reset_global()
    pkg.flight.note("serve", "flush", items=3)
    with pkg.expo.start_exposition(port=0) as server:
        with urllib.request.urlopen(server.url("/flightdump"),
                                    timeout=30) as resp:
            body = resp.read().decode()
        lines = [json.loads(ln) for ln in body.splitlines()]
        assert lines[0]["flight"] == "v1"
        assert lines[1]["kind"] == "flush"
        monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "0")
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(server.url("/flightdump"), timeout=30)
    assert server.url().startswith("http://127.0.0.1:")


def test_injected_serve_fault_dumps_a_ladder_reconstruction(
        pkg, monkeypatch, tmp_path):
    """BAD_SIGNATURE traffic while an injected backend failure poisons the
    first flush four times: the dump written ON the fault reconstructs
    the ladder (flush, RLC retry, RLC->per-group, group retry, ->oracle)
    in journal order, every verdict right."""
    dump_path = str(tmp_path / "fault.jsonl")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT_DUMP", dump_path)
    pkg.flight.reset_global()
    bad = pkg.load.BAD_SIGNATURE
    backend = pkg.load.FailingBackendProxy(pkg.rlc_backend(),
                                           fail_calls=(1, 2, 3, 4))
    with pkg.svc(backend, max_batch=4, max_wait_ms=10_000,
                 backend_retries=1) as svc:
        futs = [svc.submit("fast_aggregate", [PK], b"m0", b"ok"),
                svc.submit("fast_aggregate", [PK], b"m1", bad),
                svc.submit("fast_aggregate", [PK], b"m2", b"ok"),
                svc.submit("fast_aggregate", [PK], b"m3", b"ok")]
        results = [f.result(timeout=30) for f in futs]
    assert results == [True, False, True, True]
    assert backend.fired == 4
    assert os.path.exists(dump_path), "fault did not dump the journal"
    lines = [json.loads(ln) for ln in open(dump_path).read().splitlines()]
    assert lines[0]["reason"] == "serve_backend_degraded_to_oracle"
    kinds = [(e["plane"], e["kind"]) for e in lines[1:]]
    ladder = [("serve", "flush"), ("serve", "backend_retry"),
              ("serve", "degraded_rlc_to_groups"),
              ("serve", "backend_retry"), ("serve", "degraded_to_oracle"),
              ("flight", "fault")]
    it = iter(kinds)
    assert all(step in it for step in ladder), kinds
    stages = [e["data"].get("stage") for e in lines[1:]
              if e["kind"] == "backend_retry"]
    assert stages == ["rlc", "group"]
    seqs = [e["seq"] for e in lines[1:]]
    assert seqs == sorted(seqs)


# -- SLO tracking -------------------------------------------------------------


def test_slo_objectives_env_overrides(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SLO",
                       "serve_p99_ms=120,chain_p99_ms=77")
    objs = {o["name"]: o for o in pkg.slo.declared_objectives()}
    assert objs["serve_p99"]["threshold_s"] == pytest.approx(0.120)
    assert objs["chain_p99"]["threshold_s"] == pytest.approx(0.077)


def test_declared_objectives_equal_across_packages(monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SLO", "serve_p99_ms=500")
    assert tslo.declared_objectives() == jslo.declared_objectives()
    assert tslo.WINDOWS == jslo.WINDOWS
    assert (tslo.DEFAULT_SHED_BURN, tslo.DEFAULT_DRAIN_BURN) == (
        jslo.DEFAULT_SHED_BURN, jslo.DEFAULT_DRAIN_BURN)


def test_slo_vacuously_ok_with_no_traffic(pkg):
    tracker = pkg.slo.SloTracker(clock=lambda: 0.0)
    out = tracker.evaluate()
    assert all(e["ok"] and e["n"] == 0 for e in out.values())
    summ = pkg.profiling.summary()
    assert summ["slo.ok"] == {"gauge": 1.0}
    assert summ["slo.violations"] == {"gauge": 0.0}


def test_slo_violation_and_margin(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SLO", "serve_p99_ms=50")
    for _ in range(100):
        pkg.profiling.record_latency("serve.submit_to_result", 0.010)
    for _ in range(10):
        pkg.profiling.record_latency("serve.submit_to_result", 0.500)
    out = pkg.slo.SloTracker(clock=lambda: 0.0).evaluate()
    serve = out["serve_p99"]
    assert serve["n"] == 110 and not serve["ok"]
    assert serve["attained_ms"] > 50.0 and serve["margin"] < 1.0
    assert serve["bad_fraction"] == pytest.approx(10 / 110, abs=1e-6)
    summ = pkg.profiling.summary()
    assert summ["slo.ok"] == {"gauge": 0.0}
    assert summ["slo.violations"] == {"gauge": 1.0}


def test_slo_multi_window_burn_rates_see_a_fresh_burst(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SLO", "serve_p99_ms=50")
    t = {"now": 0.0}
    tracker = pkg.slo.SloTracker(clock=lambda: t["now"])
    tracker.evaluate()  # empty baseline checkpoint at t=0
    t["now"] = 10.0
    for _ in range(980):
        pkg.profiling.record_latency("serve.submit_to_result", 0.010)
    t["now"] = 280.0
    tracker.evaluate()  # clean checkpoint inside the slow window only
    t["now"] = 290.0
    for _ in range(10):
        pkg.profiling.record_latency("serve.submit_to_result", 0.500)
    for _ in range(10):
        pkg.profiling.record_latency("serve.submit_to_result", 0.010)
    burn = tracker.evaluate()["serve_p99"]["burn_rate"]
    assert burn["60s"] == pytest.approx(50.0)
    assert burn["300s"] == pytest.approx(1.0)
    assert pkg.profiling.summary()["slo.worst_burn_rate"] == {"gauge": 50.0}


def test_healthz_reports_slo_state(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SLO", "serve_p99_ms=50")
    pkg.slo.reset_global()
    for _ in range(50):
        pkg.profiling.record_latency("serve.submit_to_result", 0.200)
    with pkg.expo.start_exposition(port=0) as server:
        with urllib.request.urlopen(server.url("/healthz"),
                                    timeout=30) as resp:
            body = json.loads(resp.read().decode())
    assert body["ok"] is False
    assert body["slo"]["serve_p99"]["ok"] is False
    assert body["slo"]["chain_p99"]["ok"] is True  # vacuous


def test_slo_bench_flow_reports_nonzero_burn(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_SLO", "serve_p99_ms=50")
    pkg.slo.reset_global()
    pkg.slo.global_tracker().evaluate()  # the baseline
    for _ in range(80):
        pkg.profiling.record_latency("serve.submit_to_result", 0.010)
    for _ in range(20):
        pkg.profiling.record_latency("serve.submit_to_result", 0.500)
    serve = pkg.slo.global_tracker().bench_section()["serve_p99"]
    assert serve["ok"] is False
    assert serve["burn_rate"]["60s"] == pytest.approx(20.0)


def test_slo_bench_section_shape(pkg):
    for _ in range(64):
        pkg.profiling.record_latency("serve.submit_to_result", 0.020)
    section = pkg.slo.global_tracker().bench_section()
    serve = section["serve_p99"]
    assert serve["ok"] is True and serve["n"] == 64
    assert serve["margin"] > 1.0
    assert set(serve["burn_rate"]) == {"60s", "300s"}
    assert "margin" not in section["chain_p99"]


def test_metrics_and_snapshot_endpoints_serve_a_service(pkg):
    """``/metrics`` renders this process's registry and ``/snapshot`` the
    attached service's metrics: the pair the serve bench's
    SERVE_METRICS_PORT hook exposes."""
    with pkg.svc(pkg.rlc_backend(), max_batch=2, max_wait_ms=1) as svc:
        assert svc.submit("fast_aggregate", [PK], b"m", b"ok").result(10)
        with pkg.expo.start_exposition(metrics=svc.metrics,
                                       port=0) as server:
            with urllib.request.urlopen(server.url("/metrics"),
                                        timeout=30) as resp:
                text = resp.read().decode()
            with urllib.request.urlopen(server.url("/snapshot"),
                                        timeout=30) as resp:
                doc = json.loads(resp.read())
    assert ("consensus_specs_tpu_serve_submit_to_result_latency_hist_"
            "seconds_count 1") in text
    assert doc["submits"] == 1


def test_run_serve_bench_scrapes_its_metrics_port(monkeypatch):
    """The port's serve bench with SERVE_METRICS_PORT set (0: ephemeral)
    serves /metrics during the load and records the scrape, as the JAX
    bench does. Crypto-free: the backend is a verdict backend and the
    warm-up a stub."""
    from consensus_specs_tpu_torch.ops import bls_backend

    for var, value in (("SERVE_COMMITTEES", "2"), ("SERVE_K", "1"),
                       ("SERVE_EVENTS", "8"), ("SERVE_INJECT_FAILURE", "0"),
                       ("SERVE_METRICS_PORT", "0")):
        monkeypatch.setenv(var, value)
    monkeypatch.setattr(bls_backend, "batch_fast_aggregate_verify",
                        lambda pks, msgs, sigs, device=None: [True])

    class Committees:
        """build_committees with verdict-marked signatures (no signing)."""

        def __call__(self, n, k, seed=7):
            out = [([bytes([ci + 1]) * 48] * k, bytes([ci]) * 32,
                    bytes([ci]) * 96, True) for ci in range(n)]
            pks, msg, _sig, _ = out[-1]
            out[-1] = (pks, msg, tload.BAD_SIGNATURE, False)
            return out

    monkeypatch.setattr(tload, "build_committees", Committees())
    backend = tload.VerdictBackend()
    real_service = tserve.VerificationService

    def service(backend_arg=None, **kw):
        kw["oracle"] = _Oracle(tload.BAD_SIGNATURE)
        kw["bucket_fn"] = lambda k: 8
        return real_service(backend=backend, **kw)

    monkeypatch.setattr(tserve.service, "VerificationService",
                        lambda backend=None, **kw: service(backend, **kw))
    rec = tload.run_serve_bench(device="cpu")
    assert rec["lost"] == rec["wrong"] == 0
    assert rec["metrics_scrape_ok"] is True
    assert rec["metrics_scrape_lines"] > 10
    assert rec["metrics_port"] > 0


# -- concurrent scrape over the whole fleet plane -----------------------------


def test_fleet_writers_vs_scrape_hammer(pkg, monkeypatch):
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_FLIGHT", "1")
    monkeypatch.setenv("CONSENSUS_SPECS_TPU_DEVICES", "1")
    pkg.flight.reset_global()
    pkg.devices.reset_global()
    errors = []
    stop = threading.Event()
    n_threads, iters = 3, 300

    def writer(tid):
        try:
            for i in range(iters):
                pkg.profiling.record_latency("serve.submit_to_result",
                                             0.001 * (i % 7 + 1))
                pkg.flight.note("serve", "flush", items=i)
                pkg.devices.global_ledger().note_busy(tid, i * 1e-4,
                                                      i * 1e-4 + 5e-5)
        except Exception as e:  # pragma: no cover
            errors.append(e)

    def reader(server):
        try:
            while not stop.is_set():
                urllib.request.urlopen(server.url("/metrics"),
                                       timeout=30).read()
                urllib.request.urlopen(server.url("/healthz"),
                                       timeout=30).read()
        except Exception as e:  # pragma: no cover
            errors.append(e)

    with pkg.expo.start_exposition(port=0) as server:
        threads = [threading.Thread(target=writer, args=(t,))
                   for t in range(n_threads)]
        r = threading.Thread(target=reader, args=(server,))
        r.start()
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
        stop.set()
        r.join(30)
        assert not r.is_alive() and not any(t.is_alive() for t in threads)
    assert errors == []
    assert pkg.flight.global_recorder().counters()["events"] == \
        n_threads * iters
    lat = pkg.profiling.latency_summary()["serve.submit_to_result"]
    assert lat["n"] == n_threads * iters
    assert len(pkg.devices.global_ledger().snapshot()["lanes"]) == n_threads


# -- cross-process trace stitching -------------------------------------------


def _traced(mod, offset):
    """A fixed tracer through ``mod.Tracer``: three requests, one with a
    flow id, on a clock that starts at ``offset``."""
    ticks = iter([offset + 0.25 * i for i in range(400)])
    tr = mod.Tracer(capacity=8, exemplar_capacity=4,
                    clock=lambda: next(ticks))
    for rid in range(3):
        t = offset + 1.0 + rid
        req = tr.begin("fast_aggregate", 2 + rid, t,
                       flow=500 + rid if rid == 1 else None)
        tr.span(req, "queue_wait", t, t + 0.01)
        tr.span(req, "device", t + 0.01, t + 0.05)
        tr.span(req, "finalize", t + 0.05, t + 0.06)
        tr.finish(req, rid != 2, t + 0.06)
    return tr


def test_stitched_chrome_equal_across_packages():
    """Two workers' traces shipped as wire spans (rid deltas included)
    and stitched onto a router tracer: both packages give the same wire
    and the same Chrome document, each worker on its own pid, the
    router's origin rewound to the earliest worker span."""
    docs, wires = {}, {}
    for name, mod in (("jax", jtracing), ("torch", ttracing)):
        workers = {"w0": _traced(mod, 10.0), "w1": _traced(mod, 5.0)}
        wires[name] = {w: mod.wire_spans(tr, since_rid=1)
                       for w, tr in workers.items()}
        sections = {w: {"pid": 4000 + i, "traces": wires[name][w]}
                    for i, w in enumerate(sorted(workers))}
        doc = mod.stitched_chrome(_traced(mod, 20.0), sections)
        doc.pop("programRegistry")
        docs[name] = json.loads(json.dumps(doc, sort_keys=True))
        assert mod.earliest_wire_timestamp(wires[name]["w1"]) == 7.0
    assert wires["torch"] == wires["jax"]
    assert [t["rid"] for t in wires["torch"]["w0"]] == [2, 3]
    assert docs["torch"] == docs["jax"]
    pids = docs["torch"]["otherData"]["workerPids"]
    assert pids == {"w0": {"pid": 100, "os_pid": 4000},
                    "w1": {"pid": 101, "os_pid": 4001}}
    flows = [e for e in docs["torch"]["traceEvents"] if e.get("ph") == "s"]
    assert {(e["pid"], e["id"]) for e in flows} >= {(100, 501), (101, 501)}
    assert min(e["ts"] for e in docs["torch"]["traceEvents"]
               if "ts" in e) >= 0


def test_dump_stitched_trace_writes_the_document(tmp_path):
    tr = _traced(ttracing, 3.0)
    sections = {"w0": {"pid": 77, "traces": ttracing.wire_spans(tr)}}
    path = ttracing.dump_stitched_trace(str(tmp_path / "fleet.json"),
                                        sections)
    with open(path) as fh:
        doc = json.load(fh)
    assert doc["otherData"]["workerPids"]["w0"] == {"pid": 100,
                                                    "os_pid": 77}
    assert any(e.get("pid") == 100 and e.get("ph") == "X"
               for e in doc["traceEvents"])
