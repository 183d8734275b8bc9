"""The port's time-series store (consensus_specs_tpu_torch/obs/timeseries.py)
against the JAX package's, on the CPU.

Each case of tests/test_timeseries.py runs on both packages as one test
parametrised over the package: the merge algebra (max-sub wins, ties
sum, histogram deltas add), multi-resolution retention, the wire codec,
and the split-feed == single-feed property through a real JSON round
trip. Where the JAX file property-tests the algebra, both packages take
the same samples and their wires must be equal, and either package's
merge must take the other's wires. All inputs are dyadic rationals
(multiples of 2^-6), so float addition is exact and ``==`` is honest.
"""
import json
import urllib.request

import numpy as np
import pytest

from consensus_specs_tpu.utils.jax_env import force_cpu

force_cpu()

from consensus_specs_tpu.obs import exposition as jexpo  # noqa: E402
from consensus_specs_tpu.obs import hist as jhist  # noqa: E402
from consensus_specs_tpu.obs import timeseries as jts  # noqa: E402
from consensus_specs_tpu.ops import profiling as jprofiling  # noqa: E402
from consensus_specs_tpu_torch.obs import exposition as texpo  # noqa: E402
from consensus_specs_tpu_torch.obs import hist as thist  # noqa: E402
from consensus_specs_tpu_torch.obs import timeseries as tts  # noqa: E402
from consensus_specs_tpu_torch.ops import profiling as tprofiling  # noqa: E402
from tests.torch_threads import one_thread  # noqa: E402

one_thread()

PKGS = ("jax", "torch")
MODS = {"jax": (jts, jhist, jexpo), "torch": (tts, thist, texpo)}


@pytest.fixture(params=PKGS)
def ts(request):
    return MODS[request.param][0]


@pytest.fixture(autouse=True)
def _clean_profiling():
    jprofiling.reset()
    tprofiling.reset()
    yield
    jprofiling.reset()
    tprofiling.reset()


def _q(x):
    """Dyadic rational: exact under float addition."""
    return x / 64.0


def _json_roundtrip(wire):
    return json.loads(json.dumps(wire, sort_keys=True))


def _point(ts, g=None, h=None):
    p = ts.new_point()
    for label, (value, sub) in (g or {}).items():
        p["g"][label] = [value, sub]
    for label, d in (h or {}).items():
        p["h"][label] = {"counts": dict(d.get("counts", {})),
                         "count": d.get("count", 0),
                         "sum": d.get("sum", 0.0)}
    return p


# -- point algebra ------------------------------------------------------------


def test_merge_point_max_sub_wins_and_ties_sum(ts):
    a = _point(ts, g={"x": (_q(3), 5), "y": (_q(1), 2)})
    b = _point(ts, g={"x": (_q(9), 5), "y": (_q(7), 1), "z": (_q(2), 0)})
    out = ts.merge_point(a, b)
    assert out["g"]["x"] == [_q(12), 5]
    assert out["g"]["y"] == [_q(1), 2]
    assert out["g"]["z"] == [_q(2), 0]
    assert ts.merge_point(b, a) == out


def test_merge_point_hist_deltas_add(ts):
    a = _point(ts, h={"lat": {"counts": {3: 2}, "count": 2, "sum": _q(4)}})
    b = _point(ts, h={"lat": {"counts": {3: 1, 5: 4}, "count": 5,
                              "sum": _q(6)}})
    out = ts.merge_point(a, b)
    assert out["h"]["lat"] == {"counts": {3: 3, 5: 4}, "count": 7,
                               "sum": _q(10)}


def test_merge_point_is_associative(ts):
    pts = [
        _point(ts, g={"x": (_q(1), 0)},
               h={"l": {"counts": {1: 1}, "count": 1, "sum": _q(1)}}),
        _point(ts, g={"x": (_q(2), 0), "y": (_q(8), 3)}),
        _point(ts, g={"x": (_q(4), 1)},
               h={"l": {"counts": {2: 5}, "count": 5, "sum": _q(2)}}),
    ]
    left = ts.merge_point(ts.merge_point(pts[0], pts[1]), pts[2])
    right = ts.merge_point(pts[0], ts.merge_point(pts[1], pts[2]))
    assert left == right


def _synthetic_level(ts, seed, n_points=23, labels=("a", "b", "c")):
    level = {}
    for i in range(n_points):
        idx = (seed * 7 + i * 3) % 40
        g = {}
        for j, label in enumerate(labels):
            if (i + j + seed) % 2:
                g[label] = (_q((seed + 1) * (i + 1) * (j + 2)),
                            idx * 4 + (i + seed) % 4)
        h = {}
        if (i + seed) % 3 == 0:
            h["lat"] = {"counts": {(i % 6): i + 1}, "count": i + 1,
                        "sum": _q(i)}
        cur = level.get(idx)
        p = _point(ts, g=g, h=h)
        level[idx] = ts.merge_point(cur, p) if cur is not None else p
    return level


def test_downsample_commutes_with_merge(ts):
    a = _synthetic_level(ts, seed=1)
    b = _synthetic_level(ts, seed=4)
    for factor in (2, 10, 60):
        merged_then_down = ts.downsample(ts.merge_level(a, b), factor)
        down_then_merged = ts.merge_level(ts.downsample(a, factor),
                                          ts.downsample(b, factor))
        assert merged_then_down == down_then_merged, f"factor {factor}"


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_algebra_equal_across_packages(seed):
    """numpy-seeded levels through both packages' merge_level and
    downsample (every retention factor): equal results."""
    rng = np.random.default_rng(seed)
    levels = []
    for _ in range(2):
        level = {}
        for _ in range(30):
            idx = int(rng.integers(0, 50))
            g = {f"g{j}": (_q(int(rng.integers(0, 4096))),
                           idx * 4 + int(rng.integers(0, 4)))
                 for j in range(3) if rng.random() < 0.6}
            h = {}
            if rng.random() < 0.4:
                n = int(rng.integers(1, 9))
                h["lat"] = {"counts": {int(rng.integers(0, 40)): n},
                            "count": n, "sum": _q(int(rng.integers(0, 99)))}
            level[idx] = (g, h)
        levels.append(level)
    out = {}
    for name in PKGS:
        ts = MODS[name][0]
        a, b = ({i: _point(ts, g=g, h=h) for i, (g, h) in lv.items()}
                for lv in levels)
        merged = ts.merge_level(a, b)
        out[name] = [merged] + [ts.downsample(merged, f)
                                for f in (2, 10, 60)]
    assert out["torch"] == out["jax"]


# -- store ingestion + retention ----------------------------------------------


def _feed(store, t, gauges):
    store.sample(now=float(t), gauges=gauges, hists={})


def _decode(ts, wire_point):
    p = ts.new_point()
    for label, pair in wire_point["g"].items():
        p["g"][label] = [float(pair[0]), int(pair[1])]
    for label, d in wire_point["h"].items():
        p["h"][label] = {"counts": {int(i): int(n)
                                    for i, n in d["counts"].items()},
                         "count": int(d["count"]), "sum": float(d["sum"])}
    return p


def test_store_coarse_levels_equal_downsampled_fine_level(ts):
    store = ts.TimeSeriesStore(interval_s=1.0, capacity=512)
    for t in range(0, 130):
        _feed(store, t, {"g.x": _q(t), "g.y": _q(2 * t + 1)})
    wire = store.to_wire()
    fine = {int(i): p for i, p in wire["levels"]["1"].items()}
    for factor in (10, 60):
        want = ts.downsample({i: _decode(ts, p) for i, p in fine.items()},
                             factor)
        got = {int(i): _decode(ts, p)
               for i, p in wire["levels"][str(factor)].items()}
        assert got == want, f"level {factor} diverged from its definition"


def test_store_eviction_bounds_every_level(ts):
    store = ts.TimeSeriesStore(interval_s=1.0, capacity=16)
    for t in range(0, 400):
        _feed(store, t, {"g.x": _q(t)})
    wire = store.to_wire()
    for res, level in wire["levels"].items():
        assert len(level) <= 16, f"level {res} grew past capacity"
    assert store.evicted > 0 and store.samples == 400
    fine_idxs = sorted(int(i) for i in wire["levels"]["1"])
    assert fine_idxs == list(range(384, 400))


def test_store_hist_samples_record_deltas_not_cumulatives():
    out = {}
    for name in PKGS:
        ts, hist, _ = MODS[name]
        store = ts.TimeSeriesStore(interval_s=1.0, capacity=64)
        h = hist.Histogram()
        h.observe(0.001)
        h.observe(0.002)
        store.sample(now=0.0, gauges={}, hists={"lat": h})
        h.observe(0.004)
        store.sample(now=1.0, gauges={}, hists={"lat": h})
        wire = store.to_wire()
        fine = wire["levels"]["1"]
        assert fine["0"]["h"]["lat"]["count"] == 2
        assert fine["1"]["h"]["lat"]["count"] == 1
        assert wire["levels"]["10"]["0"]["h"]["lat"]["count"] == 3
        out[name] = _json_roundtrip(wire)
    assert out["torch"] == out["jax"]


def test_store_samples_the_live_profiling_state(ts):
    """With no explicit dicts, a sample reads the package's own profiling
    gauges and histograms, and export_gauges publishes the store's
    ``timeseries.*`` family there."""
    prof = tprofiling if ts is tts else jprofiling
    prof.set_gauge("serve.queue_depth", 3.0)
    prof.record_latency("serve.submit_to_result", 0.01)
    store = ts.TimeSeriesStore(interval_s=1.0, capacity=8)
    store.sample(now=5.0)
    store.export_gauges()
    point = store.to_wire()["levels"]["1"]["5"]
    assert point["g"]["serve.queue_depth"] == [3.0, 5]
    assert point["h"]["serve.submit_to_result"]["count"] == 1
    gauges = prof.stats_and_gauges()[1]
    assert gauges["timeseries.samples"] == 1
    assert gauges["timeseries.points"] == 3


# -- the acceptance property: split feed == single feed -----------------------


def _label_split_feeds(ts):
    single = ts.TimeSeriesStore(interval_s=1.0, capacity=256)
    w0 = ts.TimeSeriesStore(interval_s=1.0, capacity=256)
    w1 = ts.TimeSeriesStore(interval_s=1.0, capacity=256)
    for t in range(0, 75):
        g0 = {"serve[w0].queue_depth": _q(t % 13),
              "serve[w0].submits": _q(3 * t)}
        g1 = {"serve[w1].queue_depth": _q((t + 5) % 11),
              "serve[w1].submits": _q(2 * t + 1)}
        single.sample(now=float(t), gauges={**g0, **g1}, hists={})
        w0.sample(now=float(t), gauges=g0, hists={})
        w1.sample(now=float(t), gauges=g1, hists={})
    return single, [w0, w1]


def test_merged_fleet_wire_is_bitexact_vs_single_store_label_split(ts):
    single, workers = _label_split_feeds(ts)
    merged = ts.merge_wires([_json_roundtrip(w.to_wire()) for w in workers])
    assert _json_roundtrip(merged) == _json_roundtrip(single.to_wire())


def test_merged_fleet_wire_is_bitexact_vs_single_store_time_split(ts):
    single = ts.TimeSeriesStore(interval_s=1.0, capacity=256)
    early = ts.TimeSeriesStore(interval_s=1.0, capacity=256)
    late = ts.TimeSeriesStore(interval_s=1.0, capacity=256)
    for t in range(0, 64):
        g = {"health.participation_rate": _q(40 + t % 9)}
        single.sample(now=float(t), gauges=g, hists={})
        (early if t < 31 else late).sample(now=float(t), gauges=g,
                                           hists={})
    merged = ts.merge_wires([_json_roundtrip(early.to_wire()),
                             _json_roundtrip(late.to_wire())])
    assert _json_roundtrip(merged) == _json_roundtrip(single.to_wire())


def test_wires_and_merges_equal_across_packages():
    """The same split feeds into both packages' stores give equal wires;
    each package merges a JAX worker's wire with a port worker's to the
    wire of a single store, and renders it alike."""
    feeds = {name: _label_split_feeds(MODS[name][0]) for name in PKGS}
    for i in range(2):
        assert _json_roundtrip(feeds["torch"][1][i].to_wire()) == \
            _json_roundtrip(feeds["jax"][1][i].to_wire())
    mixed = [_json_roundtrip(feeds["jax"][1][0].to_wire()),
             _json_roundtrip(feeds["torch"][1][1].to_wire())]
    single = _json_roundtrip(feeds["jax"][0].to_wire())
    merged = {name: MODS[name][0].merge_wires(mixed) for name in PKGS}
    for name in PKGS:
        assert _json_roundtrip(merged[name]) == single, name
    assert json.dumps(tts.render_wire(merged["torch"]), sort_keys=True) == \
        json.dumps(jts.render_wire(merged["jax"]), sort_keys=True)


def test_merged_render_is_bitexact_too(ts):
    single, workers = _label_split_feeds(ts)
    merged = ts.merge_wires([w.to_wire() for w in workers])
    assert json.dumps(ts.render_wire(merged), sort_keys=True) == \
        json.dumps(single.render(), sort_keys=True)


def test_merge_is_idempotent_on_duplicate_feeds(ts):
    single, _ = _label_split_feeds(ts)
    wire = single.to_wire()
    empty = ts.TimeSeriesStore(interval_s=1.0, capacity=4).to_wire()
    assert _json_roundtrip(ts.merge_wires([wire, empty])) == \
        _json_roundtrip(wire)


# -- wire hygiene -------------------------------------------------------------


def test_merge_rejects_wire_version_mismatch(ts):
    assert tts.TS_WIRE_VERSION == jts.TS_WIRE_VERSION
    good = ts.TimeSeriesStore(interval_s=1.0).to_wire()
    bad = dict(good, v=ts.TS_WIRE_VERSION + 1)
    with pytest.raises(ts.TimeSeriesError):
        ts.merge_wires([good, bad])
    with pytest.raises(ts.TimeSeriesError):
        ts.render_wire({"levels": {}})


def test_merge_rejects_interval_mismatch(ts):
    a = ts.TimeSeriesStore(interval_s=1.0)
    b = ts.TimeSeriesStore(interval_s=6.0)
    _feed(a, 0, {"x": 1.0})
    _feed(b, 0, {"x": 1.0})
    with pytest.raises(ts.TimeSeriesError):
        ts.merge_wires([a.to_wire(), b.to_wire()])


def test_merge_rejects_malformed_points(ts):
    good = ts.TimeSeriesStore(interval_s=1.0)
    _feed(good, 0, {"x": 1.0})
    wire = _json_roundtrip(good.to_wire())
    wire["levels"]["1"]["0"]["g"]["x"] = ["not-a-number", None]
    with pytest.raises(ts.TimeSeriesError):
        ts.merge_wires([wire])


# -- rendering + artifacts ----------------------------------------------------


def test_render_wire_shape_and_percentiles():
    docs = {}
    for name in PKGS:
        ts, hist, _ = MODS[name]
        store = ts.TimeSeriesStore(interval_s=2.0, capacity=64)
        h = hist.Histogram()
        for _ in range(100):
            h.observe(0.010)
        store.sample(now=0.0, gauges={"g.x": _q(1)}, hists={"lat": h})
        doc = store.render()
        assert doc["v"] == ts.TS_WIRE_VERSION and doc["interval_s"] == 2.0
        by_res = {lv["resolution_s"]: lv for lv in doc["levels"]}
        assert set(by_res) == {2.0, 20.0, 120.0}
        point = by_res[2.0]["points"][0]
        assert point["t"] == 0.0 and point["gauges"]["g.x"] == _q(1)
        lat = point["hists"]["lat"]
        assert lat["count"] == 100
        assert 8.0 <= lat["p50_ms"] <= 12.0 and 8.0 <= lat["p99_ms"] <= 12.0
        docs[name] = doc
    assert docs["torch"] == docs["jax"]


def test_dump_jsonl_is_one_header_plus_one_line_per_point(ts, tmp_path):
    store = ts.TimeSeriesStore(interval_s=1.0, capacity=64)
    for t in range(0, 12):
        _feed(store, t, {"g.x": _q(t)})
    path = store.dump_jsonl(str(tmp_path / "ts.jsonl"))
    lines = [json.loads(ln) for ln in open(path) if ln.strip()]
    header, rows = lines[0], lines[1:]
    assert header["timeseries"] == f"v{ts.TS_WIRE_VERSION}"
    assert header["points"] == len(rows)
    assert header["levels"] == [1.0, 10.0, 60.0]
    assert len(rows) == 12 + 2 + 1
    for row in rows:
        assert set(row) >= {"idx", "t", "gauges", "hists", "resolution_s"}


def test_timeseries_endpoint_serves_merged_document(ts):
    expo = texpo if ts is tts else jexpo
    single, workers = _label_split_feeds(ts)
    merged = ts.merge_wires([w.to_wire() for w in workers])
    with expo.start_exposition(
            port=0, timeseries_fn=lambda: ts.render_wire(merged)) as server:
        with urllib.request.urlopen(server.url("/timeseries"),
                                    timeout=30) as resp:
            doc = json.loads(resp.read())
    assert doc == json.loads(json.dumps(single.render()))
