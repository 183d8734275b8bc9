"""Observability snapshot wire format: what a fleet worker ships home (the
port's copy of consensus_specs_tpu/obs/snapshot.py, the same wire).

Every metric type of the obs plane aggregates exactly across processes:
``hist.py`` histograms merge by adding fixed-bound bucket counts, stat
accumulators merge by summing calls and seconds, flight events carry
their own sequence numbers. This module is the process boundary's codec:
a worker serializes its whole observability state to ONE JSON-safe dict
(``take_process_snapshot``), ships it over the worker protocol
(``serve/worker.py``), and the fleet aggregator (``obs/fleet.py``) decodes
and merges it bit-identically to an in-process merge of the same
histograms:

    merge(from_wire(to_wire(a)), from_wire(to_wire(b)))
        == merge(a, b)          (bucket counts, count, sum, min, max)

JSON is the carrier (the worker protocol is ndjson over pipes), so the
sparse bucket dict's int keys become strings on the wire and are restored
on decode; floats survive exactly (json round-trips float repr). The
version and field names are the JAX package's: a snapshot from either
package decodes, and merges, in the other's aggregator.
"""
import os
from typing import Dict, List, Optional

from . import hist

# wire version: a worker and an aggregator from different builds refuse
# to merge silently-incompatible state (bump on any layout change)
WIRE_VERSION = 1


class WireError(ValueError):
    """A snapshot that cannot be decoded (wrong version / malformed)."""


# -- histogram codec ----------------------------------------------------------


def hist_to_wire(h: hist.Histogram) -> Dict:
    """One histogram as a JSON-safe dict (sparse counts, str bucket keys)."""
    st = h.state()
    return {
        "counts": {str(idx): n for idx, n in st["counts"].items()},
        "count": st["count"],
        "sum": st["sum"],
        "min": st["min"],
        "max": st["max"],
    }


def hist_from_wire(wire: Dict) -> hist.Histogram:
    """Inverse of :func:`hist_to_wire`; the reconstructed histogram is
    state-identical to the source (same buckets, count, sum, extremes)."""
    try:
        h = hist.Histogram()
        h._counts = {int(idx): int(n) for idx, n in wire["counts"].items()}
        h.count = int(wire["count"])
        h.sum = float(wire["sum"])
        h.min = None if wire.get("min") is None else float(wire["min"])
        h.max = None if wire.get("max") is None else float(wire["max"])
        return h
    except (KeyError, TypeError, ValueError, AttributeError) as e:
        raise WireError(f"malformed histogram wire dict: {e}") from e


# -- per-process resource gauges ---------------------------------------------

# the gauge family every snapshot refreshes (drift-gated like the rest:
# registered in obs/registry.py, documented in the README metric table).
# Resources are INSTANCE state — the fleet surface republishes them as
# `process[<worker>].<name>`, never summed across workers.
PROCESS_GAUGE_LABELS = (
    "process.rss_bytes",
    "process.cpu_s",
    "process.open_fds",
)


def read_process_resources() -> Dict[str, float]:
    """Current resident set, cumulative CPU seconds, and open fd count
    for THIS process. Linux-first (/proc), degrading gracefully: RSS
    falls back to ``getrusage`` peak-RSS where /proc is absent, fd count
    reports -1 where it cannot be read (macOS without /proc)."""
    import resource

    rss = -1.0
    try:
        with open("/proc/self/statm", "r", encoding="ascii") as f:
            pages = int(f.read().split()[1])
        rss = float(pages * os.sysconf("SC_PAGE_SIZE"))
    except (OSError, ValueError, IndexError):
        try:
            # ru_maxrss: peak, in KiB on Linux / bytes on macOS — only a
            # fallback; the /proc path above reports CURRENT rss
            import sys

            ru = resource.getrusage(resource.RUSAGE_SELF)
            scale = 1 if sys.platform == "darwin" else 1024
            rss = float(ru.ru_maxrss * scale)
        except (OSError, ValueError):
            pass
    ru = resource.getrusage(resource.RUSAGE_SELF)
    cpu_s = float(ru.ru_utime + ru.ru_stime)
    try:
        fds = float(len(os.listdir("/proc/self/fd")))
    except OSError:
        fds = -1.0
    return {
        "process.rss_bytes": rss,
        "process.cpu_s": cpu_s,
        "process.open_fds": fds,
    }


def export_process_gauges() -> Dict[str, float]:
    """Refresh the ``process.*`` family onto the profiling surface (and
    so into this snapshot's gauge dict and every TSDB sample)."""
    from ..ops import profiling

    values = read_process_resources()
    for label in PROCESS_GAUGE_LABELS:
        profiling.set_gauge(label, values[label])
    return values


# -- whole-process snapshot ---------------------------------------------------


def take_process_snapshot(worker: Optional[str] = None,
                          extra: Optional[Dict] = None,
                          flight_since: int = 0,
                          spans_since: int = 0) -> Dict:
    """The process's full observability state as one JSON-safe dict:
    latency histograms (wire form), stat accumulators, gauges, and — when
    the flight recorder is armed — the journal ring with its counters.
    ``worker`` stamps the snapshot (the fleet label); ``extra`` attaches
    caller payload (e.g. the worker's ``ServeMetrics.snapshot()``);
    ``flight_since`` ships only flight events with ``seq`` past it (the
    fleet control tick passes its last merged seq so the steady-state
    snapshot carries deltas, not the whole 4096-event ring — counters
    stay cumulative either way); ``spans_since`` does the same for
    completed trace spans (rid-delta'd) when tracing is armed.

    Three sections are armed-only: ``process.*`` resource
    gauges refresh into the gauge dict unconditionally (they cost three
    /proc reads), the ``timeseries`` section rides when the TSDB env is
    set, and the ``spans`` section rides when tracing is enabled."""
    from ..ops import profiling

    from . import flight, timeseries, tracing

    export_process_gauges()
    stats, gauges = profiling.stats_and_gauges()
    snap = {
        "v": WIRE_VERSION,
        "worker": worker,
        "pid": os.getpid(),
        "stats": stats,
        "gauges": gauges,
        "hists": {label: hist_to_wire(h)
                  for label, h in profiling.latency_histograms().items()},
    }
    rec = flight.maybe_recorder()
    if rec is not None:
        events = rec.events()
        if flight_since:
            events = [e for e in events
                      if int(e.get("seq", 0)) > int(flight_since)]
        snap["flight"] = {
            "counters": rec.counters(),
            "events": events,
        }
    store = timeseries.maybe_store()
    if store is not None:
        snap["timeseries"] = store.to_wire()
    tracer = tracing.maybe_tracer()
    if tracer is not None:
        snap["spans"] = {
            "since": int(spans_since),
            "traces": tracing.wire_spans(tracer, spans_since),
        }
    if extra:
        snap["extra"] = extra
    return snap


def check_version(snap: Dict) -> Dict:
    """Validate a decoded snapshot's wire version; returns it unchanged."""
    v = snap.get("v") if isinstance(snap, dict) else None
    if v != WIRE_VERSION:
        raise WireError(
            f"snapshot wire version {v!r} != supported {WIRE_VERSION}")
    return snap


# -- merge primitives (exact, commutative, associative) -----------------------


def merge_hist_wires(wires: List[Dict]) -> hist.Histogram:
    """Merge any number of wire-form histograms into one Histogram —
    exactly the in-process ``Histogram.merge`` fold over the decoded
    inputs (which is what the round-trip property test pins)."""
    out = hist.Histogram()
    for w in wires:
        out = out.merge(hist_from_wire(w))
    return out


def merge_stat_entries(entries: List[Dict]) -> Dict:
    """Stat-accumulator merge: calls and total seconds SUM (each process
    observed disjoint calls), max is the max — same algebra the in-process
    accumulator applies one observation at a time."""
    out = {"calls": 0, "total_s": 0.0, "max_s": 0.0}
    for e in entries:
        out["calls"] += int(e.get("calls", 0))
        out["total_s"] += float(e.get("total_s", 0.0))
        out["max_s"] = max(out["max_s"], float(e.get("max_s", 0.0)))
    return out
