"""Bounded multi-resolution time-series store (the port's copy of
consensus_specs_tpu/obs/timeseries.py: the same rings, merge algebra and
wire).

Every other observability surface answers "what is the value NOW"
(gauges, burn windows, a bounded flight ring). This store answers "what
happened over the last N thousand seconds, across every worker" with
bounded memory:

- ``sample()`` captures a fixed-interval snapshot of every gauge plus the
  DELTA of every latency histogram since the previous sample (raw
  log-bucket counts, not percentiles: p50/p99 are computed at render time
  from whatever bucket mass a point ends up holding, so merging never
  averages percentiles);
- three ring levels retain the samples at 1x, 10x and 60x the base
  interval (1 s -> 10 s -> 60 s by default): each level holds
  ``capacity`` points, so coarser levels see proportionally further back;
- the whole store serializes to ONE JSON-safe wire dict that rides the
  worker snapshot (``obs/snapshot.py``), and cross-worker merge is EXACT.

Merge algebra: a point stores

- per gauge label, ``[value, sub]`` where ``sub`` is the base-resolution
  sample index the value was taken at. Downsampling (folding base points
  into a coarser window) and cross-worker merge obey ONE rule: group
  contributions by ``sub``; the largest ``sub`` present wins;
  contributions AT that ``sub`` sum. Because the rule depends only on the
  (sub, value) multiset, downsampling commutes with merge exactly;
- per histogram label, the window's bucket-count delta (sparse counts +
  count + sum). Deltas add under both downsampling and merge.

The ``/timeseries`` endpoint (``obs/exposition.py``) serves the rendered
document; ``dump_jsonl`` writes one line per retained point. Arm the
worker-side sampler with ``CONSENSUS_SPECS_TPU_TS=1`` (interval
``CONSENSUS_SPECS_TPU_TS_INTERVAL_MS``, per-level ring size
``CONSENSUS_SPECS_TPU_TS_CAP``).
"""
import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

from . import hist

TS_ENV = "CONSENSUS_SPECS_TPU_TS"
INTERVAL_ENV = "CONSENSUS_SPECS_TPU_TS_INTERVAL_MS"
CAP_ENV = "CONSENSUS_SPECS_TPU_TS_CAP"

# wire version for the timeseries section (independent of the snapshot
# envelope's version: the section is optional, so an old aggregator just
# ignores it — but two DIFFERENT timeseries layouts must never merge)
TS_WIRE_VERSION = 1

# ring levels as multiples of the base sample interval: 1s -> 10s -> 60s
# at the default 1s base
RESOLUTIONS = (1, 10, 60)


def ts_enabled() -> bool:
    """Dynamic env check (same contract as ``profiling.enabled()``)."""
    return os.environ.get(TS_ENV, "0") not in ("", "0")


def configured_interval_s() -> float:
    try:
        ms = float(os.environ.get(INTERVAL_ENV, "1000"))
    except ValueError:
        ms = 1000.0
    return max(1e-3, ms / 1e3)


def configured_capacity() -> int:
    try:
        cap = int(os.environ.get(CAP_ENV, "960"))
    except ValueError:
        cap = 960
    return max(8, cap)


class TimeSeriesError(ValueError):
    """A timeseries wire doc that cannot be decoded or merged."""


# -- point algebra (module-level so the property tests hit it directly) ------


def new_point() -> Dict:
    return {"g": {}, "h": {}}


def _add_hist_delta(target: Dict, label: str, delta: Dict) -> None:
    cur = target.get(label)
    if cur is None:
        target[label] = {"counts": dict(delta["counts"]),
                         "count": int(delta["count"]),
                         "sum": float(delta["sum"])}
        return
    for idx, n in delta["counts"].items():
        cur["counts"][idx] = cur["counts"].get(idx, 0) + int(n)
    cur["count"] += int(delta["count"])
    cur["sum"] += float(delta["sum"])


def merge_point(a: Dict, b: Dict) -> Dict:
    """The one combining rule (docstring: max-sub wins, ties sum; hist
    deltas add). Commutative and associative — both downsampling and
    cross-worker merge are folds of this."""
    out = new_point()
    for label, (value, sub) in a["g"].items():
        out["g"][label] = [value, sub]
    for label, (value, sub) in b["g"].items():
        cur = out["g"].get(label)
        if cur is None or sub > cur[1]:
            out["g"][label] = [value, sub]
        elif sub == cur[1]:
            out["g"][label] = [cur[0] + value, sub]
        # sub < cur[1]: an older contribution loses to the newer sample
    for label, delta in a["h"].items():
        _add_hist_delta(out["h"], label, delta)
    for label, delta in b["h"].items():
        _add_hist_delta(out["h"], label, delta)
    return out


def downsample(points: Dict[int, Dict], factor: int) -> Dict[int, Dict]:
    """Fold a level's ``{idx: point}`` map ``factor``-fold coarser — the
    same fold ``sample()`` maintains incrementally, exposed standalone so
    the commutes-with-merge property is testable against the definition."""
    out: Dict[int, Dict] = {}
    for idx in sorted(points):
        coarse = idx // factor
        cur = out.get(coarse)
        out[coarse] = (merge_point(cur, points[idx]) if cur is not None
                       else merge_point(new_point(), points[idx]))
    return out


def merge_level(a: Dict[int, Dict], b: Dict[int, Dict]) -> Dict[int, Dict]:
    """Pointwise merge of two ``{idx: point}`` maps."""
    out = {idx: merge_point(new_point(), p) for idx, p in a.items()}
    for idx, p in b.items():
        cur = out.get(idx)
        out[idx] = merge_point(cur, p) if cur is not None \
            else merge_point(new_point(), p)
    return out


# -- the store ---------------------------------------------------------------


class TimeSeriesStore:
    """Fixed-interval sampler + multi-resolution retention rings.

    ``interval_s`` is the base sample interval; ``capacity`` bounds each
    resolution level in POINTS (coarser levels therefore retain
    proportionally longer horizons). ``clock`` is injectable (a
    simulated clock, or a counter in tests)."""

    def __init__(self, interval_s: float = 1.0, capacity: int = 960,
                 clock=time.time, resolutions=RESOLUTIONS):
        assert interval_s > 0 and capacity > 0
        self._interval_s = float(interval_s)
        self._capacity = int(capacity)
        self._clock = clock
        self._resolutions = tuple(int(r) for r in resolutions)
        assert self._resolutions and self._resolutions[0] == 1
        self._lock = threading.Lock()
        # resolution -> {coarse idx -> point}; ingestion maintains every
        # level directly (identical to downsampling level 0 by
        # construction — the commute property's incremental form)
        self._levels: Dict[int, Dict[int, Dict]] = {
            r: {} for r in self._resolutions}
        # per-label histogram state at the previous sample (delta source)
        self._prev_hist: Dict[str, Dict] = {}
        self.samples = 0
        self.evicted = 0

    @property
    def interval_s(self) -> float:
        return self._interval_s

    # -- ingestion -----------------------------------------------------------

    def sample(self, now: Optional[float] = None,
               gauges: Optional[Dict[str, float]] = None,
               hists: Optional[Dict[str, hist.Histogram]] = None) -> int:
        """Record one sample at ``now`` (default: the store clock).
        ``gauges``/``hists`` default to the live ``ops/profiling`` state;
        tests pass explicit dicts. Returns the base sample
        index the sample landed on. Samples are expected in
        non-decreasing time order (process clocks are monotone; a
        re-sample inside the same interval updates the point in place)."""
        if gauges is None or hists is None:
            from ..ops import profiling

            if gauges is None:
                _stats, gauges = profiling.stats_and_gauges()
            if hists is None:
                hists = profiling.latency_histograms()
        if now is None:
            now = self._clock()
        sub = int(math.floor(float(now) / self._interval_s))
        deltas: Dict[str, Dict] = {}
        with self._lock:
            for label, h in hists.items():
                st = h.state()
                prev = self._prev_hist.get(label)
                if prev is None:
                    delta_counts = dict(st["counts"])
                    delta_count = st["count"]
                    delta_sum = st["sum"]
                else:
                    delta_counts = {}
                    for idx, n in st["counts"].items():
                        d = n - prev["counts"].get(idx, 0)
                        if d:
                            delta_counts[idx] = d
                    delta_count = st["count"] - prev["count"]
                    delta_sum = st["sum"] - prev["sum"]
                self._prev_hist[label] = {"counts": dict(st["counts"]),
                                          "count": st["count"],
                                          "sum": st["sum"]}
                if delta_count:
                    deltas[label] = {"counts": delta_counts,
                                     "count": delta_count,
                                     "sum": delta_sum}
            for r in self._resolutions:
                level = self._levels[r]
                coarse = sub // r
                point = level.get(coarse)
                if point is None:
                    point = level[coarse] = new_point()
                for label, value in gauges.items():
                    cur = point["g"].get(label)
                    if cur is None or sub >= cur[1]:
                        point["g"][label] = [float(value), sub]
                for label, delta in deltas.items():
                    _add_hist_delta(point["h"], label, delta)
                while len(level) > self._capacity:
                    level.pop(min(level))
                    self.evicted += 1
            self.samples += 1
        return sub

    def export_gauges(self) -> None:
        """Publish the store's own health (``timeseries.*`` family)."""
        from ..ops import profiling

        with self._lock:
            points = sum(len(level) for level in self._levels.values())
            samples = self.samples
            evicted = self.evicted
        profiling.set_gauge("timeseries.samples", samples)
        profiling.set_gauge("timeseries.points", points)
        profiling.set_gauge("timeseries.evicted", evicted)

    # -- wire codec ----------------------------------------------------------

    def to_wire(self) -> Dict:
        """The whole store as one JSON-safe dict (str keys throughout —
        the worker protocol is ndjson, same carrier rules as
        ``obs/snapshot.py``)."""
        with self._lock:
            levels = {}
            for r, level in self._levels.items():
                levels[str(r)] = {
                    str(idx): _point_to_wire(p)
                    for idx, p in sorted(level.items())}
            return {"v": TS_WIRE_VERSION,
                    "interval_s": self._interval_s,
                    "levels": levels}

    def merged_with(self, wires: List[Dict]) -> Dict:
        """This store's wire merged with ``wires`` (the router overlays
        its own store onto the worker feeds)."""
        return merge_wires([self.to_wire()] + list(wires))

    # -- rendering -----------------------------------------------------------

    def render(self) -> Dict:
        return render_wire(self.to_wire())

    def dump_jsonl(self, path: str) -> str:
        """One header line + one line per retained point (CI artifact)."""
        return dump_wire_jsonl(self.to_wire(), path)


def _point_to_wire(point: Dict) -> Dict:
    return {
        "g": {label: [value, sub]
              for label, (value, sub) in sorted(point["g"].items())},
        "h": {label: {"counts": {str(i): n
                                 for i, n in sorted(d["counts"].items())},
                      "count": d["count"], "sum": d["sum"]}
              for label, d in sorted(point["h"].items())},
    }


def _point_from_wire(wire: Dict) -> Dict:
    try:
        point = new_point()
        for label, pair in wire.get("g", {}).items():
            point["g"][label] = [float(pair[0]), int(pair[1])]
        for label, d in wire.get("h", {}).items():
            point["h"][label] = {
                "counts": {int(i): int(n) for i, n in d["counts"].items()},
                "count": int(d["count"]), "sum": float(d["sum"])}
        return point
    except (KeyError, IndexError, TypeError, ValueError) as e:
        raise TimeSeriesError(f"malformed timeseries point: {e}") from e


def check_wire(wire: Dict) -> Dict:
    v = wire.get("v") if isinstance(wire, dict) else None
    if v != TS_WIRE_VERSION:
        raise TimeSeriesError(
            f"timeseries wire version {v!r} != supported {TS_WIRE_VERSION}")
    return wire


def merge_wires(wires: List[Dict]) -> Dict:
    """Exact merge of any number of wire docs into one (the fleet's
    ``/timeseries`` source). All inputs must agree on the base interval —
    sample indices are only comparable on one grid."""
    wires = [check_wire(w) for w in wires if w]
    if not wires:
        return {"v": TS_WIRE_VERSION, "interval_s": 1.0, "levels": {}}
    interval = float(wires[0].get("interval_s", 1.0))
    for w in wires[1:]:
        if float(w.get("interval_s", 1.0)) != interval:
            raise TimeSeriesError(
                "cannot merge timeseries with different base intervals: "
                f"{interval} vs {w.get('interval_s')}")
    levels: Dict[str, Dict[int, Dict]] = {}
    for w in wires:
        for res, points in w.get("levels", {}).items():
            decoded = {int(idx): _point_from_wire(p)
                       for idx, p in points.items()}
            cur = levels.get(res)
            levels[res] = (merge_level(cur, decoded) if cur is not None
                           else decoded)
    return {"v": TS_WIRE_VERSION, "interval_s": interval,
            "levels": {res: {str(idx): _point_to_wire(p)
                             for idx, p in sorted(points.items())}
                       for res, points in sorted(
                           levels.items(), key=lambda kv: int(kv[0]))}}


def _delta_percentiles(d: Dict) -> Dict:
    """p50/p99 of one point's histogram-delta mass, computed at render
    time from the raw buckets (merging happened on counts, so the
    percentile of the merged mass is the percentile of the merge)."""
    h = hist.Histogram()
    h._counts = {int(i): int(n) for i, n in d["counts"].items()}
    h.count = int(d["count"])
    h.sum = float(d["sum"])
    count = max(1, h.count)
    return {
        "count": h.count,
        "mean_ms": round(h.sum / count * 1e3, 3),
        "p50_ms": round(h.percentile(50.0) * 1e3, 3),
        "p99_ms": round(h.percentile(99.0) * 1e3, 3),
    }


def render_wire(wire: Dict) -> Dict:
    """The ``/timeseries`` document: per level, time-ordered points with
    plain gauge values and histogram-delta percentile summaries."""
    check_wire(wire)
    interval = float(wire.get("interval_s", 1.0))
    levels = []
    for res in sorted(wire.get("levels", {}), key=int):
        r = int(res)
        points = []
        for idx_s in sorted(wire["levels"][res], key=int):
            idx = int(idx_s)
            p = wire["levels"][res][idx_s]
            points.append({
                "idx": idx,
                "t": round(idx * r * interval, 6),
                "gauges": {label: pair[0]
                           for label, pair in sorted(p.get("g", {}).items())},
                "hists": {label: _delta_percentiles(d)
                          for label, d in sorted(p.get("h", {}).items())},
            })
        levels.append({"resolution_s": round(r * interval, 6),
                       "points": points})
    return {"v": TS_WIRE_VERSION, "interval_s": interval, "levels": levels}


def dump_wire_jsonl(wire: Dict, path: str) -> str:
    """JSONL artifact: one header line, then one line per (resolution,
    point) in time order — greppable and plottable without loading the
    whole document."""
    from . import fsio

    doc = render_wire(wire)
    header = {"timeseries": "v%d" % TS_WIRE_VERSION,
              "interval_s": doc["interval_s"],
              "levels": [lv["resolution_s"] for lv in doc["levels"]],
              "points": sum(len(lv["points"]) for lv in doc["levels"])}
    lines = [json.dumps(header, sort_keys=True)]
    for lv in doc["levels"]:
        for p in lv["points"]:
            row = dict(p, resolution_s=lv["resolution_s"])
            lines.append(json.dumps(row, sort_keys=True))
    return fsio.atomic_write_text(path, "\n".join(lines) + "\n")


# -- process-global store ----------------------------------------------------

# reentrant: start_sampler() resolves the default store via
# global_store() while already holding the lock
_global_lock = threading.RLock()
_global: Optional[TimeSeriesStore] = None
_sampler: Optional["_Sampler"] = None


def global_store() -> TimeSeriesStore:
    """The process store (created on first use from the env knobs)."""
    global _global
    with _global_lock:
        if _global is None:
            _global = TimeSeriesStore(interval_s=configured_interval_s(),
                                      capacity=configured_capacity())
        return _global


def maybe_store() -> Optional[TimeSeriesStore]:
    """The global store when the telemetry plane is armed, else None —
    the exact value snapshot/exposition sites branch on."""
    return global_store() if ts_enabled() else None


class _Sampler:
    """Daemon thread driving ``store.sample()`` at the base interval."""

    def __init__(self, store: TimeSeriesStore, interval_s: float):
        self._store = store
        self._interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, name="obs-timeseries-sampler", daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.wait(self._interval_s):
            try:
                self._store.sample()
                self._store.export_gauges()
            except Exception:
                pass  # a failed sample must never kill the sampler

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self._thread.join(timeout)


def start_sampler(store: Optional[TimeSeriesStore] = None,
                  interval_s: Optional[float] = None) -> _Sampler:
    """Start (or return) the process sampler — what a fleet worker arms
    at boot when ``CONSENSUS_SPECS_TPU_TS=1``."""
    global _sampler
    with _global_lock:
        if _sampler is None:
            _sampler = _Sampler(
                store if store is not None else global_store(),
                interval_s if interval_s is not None
                else configured_interval_s())
        return _sampler


def reset_global() -> None:
    """Drop the global store + sampler (tests / multi-run benches)."""
    global _global, _sampler
    with _global_lock:
        if _sampler is not None:
            _sampler.close()
        _sampler = None
        _global = None
