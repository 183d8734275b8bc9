"""Device-pipeline observability: the port's copy of
consensus_specs_tpu/ops/profiling.py.

- ``record(...)`` is called by ``vm.execute`` around every program run
  (and by the serve plane); stats accumulate per label in-process.
- ``record_latency(...)`` feeds a mergeable log-bucketed histogram
  (``obs/hist.py``: fixed base-2 / 8-sub-bucket bounds, so histograms from
  different devices, nodes and processes add exactly). Every percentile
  family carries ``n``, its observation count.
- ``set_gauge(...)`` publishes point-in-time values (queue depth, cache
  hit rate, batch occupancy, the ``bls.*`` counters).
- ``summary()`` / ``snapshot()`` / ``report()`` expose all three;
  ``stats_and_gauges()`` and ``latency_histograms()`` hand one-lock copies
  to the Prometheus renderer (``obs/registry.py``). The bench entry
  attaches the summary to its line when ``enabled()``
  (CONSENSUS_SPECS_TPU_PROFILE=1).
- ``trace(log_dir)`` wraps a block in a ``torch.profiler`` trace (CPU
  activity, and the card's kernels where there is one) written for
  TensorBoard: the counterpart of the JAX package's jax.profiler hook.
"""
import contextlib
import os
import threading
import time
from collections import defaultdict
from typing import Dict

from ..obs import hist


def enabled() -> bool:
    """Whether CONSENSUS_SPECS_TPU_PROFILE=1, re-read on every call, so a
    flip after import takes effect at once."""
    return os.environ.get("CONSENSUS_SPECS_TPU_PROFILE") == "1"


_stats: Dict[str, Dict[str, float]] = defaultdict(
    lambda: {"calls": 0, "total_s": 0.0, "max_s": 0.0}
)

# count of live latency-histogram families, published as a gauge
HIST_FAMILIES_LABEL = "hist.families"

_lat: Dict[str, hist.Histogram] = {}
# one lock for every accumulator: the serve plane writes timings, gauges
# and latencies concurrently from submit threads and its two stage threads
_lock = threading.Lock()
_gauges: Dict[str, float] = {}


def record(label: str, seconds: float) -> None:
    with _lock:
        s = _stats[label]
        s["calls"] += 1
        s["total_s"] += seconds
        s["max_s"] = max(s["max_s"], seconds)


def record_latency(label: str, seconds: float) -> None:
    """One latency observation into ``label``'s mergeable histogram."""
    with _lock:
        h = _lat.get(label)
        if h is None:
            h = _lat[label] = hist.Histogram()
            _gauges[HIST_FAMILIES_LABEL] = float(len(_lat))
    h.observe(seconds)


def stats_and_gauges():
    """One-lock copies of the stat accumulators and the gauges."""
    with _lock:
        return ({k: dict(v) for k, v in _stats.items()}, dict(_gauges))


def latency_histograms() -> Dict[str, hist.Histogram]:
    """Detached histogram copies per label."""
    with _lock:
        snap = dict(_lat)
    return {label: h.snapshot() for label, h in sorted(snap.items())}


def latency_summary() -> Dict[str, Dict[str, float]]:
    return {label: h.summary() for label, h in latency_histograms().items()}


def set_gauge(label: str, value: float) -> None:
    with _lock:
        _gauges[label] = round(float(value), 6)


@contextlib.contextmanager
def timed(label: str):
    t0 = time.perf_counter()
    try:
        yield
    finally:
        record(label, time.perf_counter() - t0)


def summary() -> Dict[str, Dict[str, float]]:
    with _lock:
        stats = {k: dict(v) for k, v in _stats.items()}
        gauges = dict(_gauges)
    out = {
        k: {
            "calls": int(v["calls"]),
            "total_s": round(v["total_s"], 4),
            "mean_s": round(v["total_s"] / max(1, v["calls"]), 4),
            "max_s": round(v["max_s"], 4),
        }
        for k, v in sorted(stats.items())
    }
    out.update(latency_summary())
    for label, value in sorted(gauges.items()):
        out[label] = {"gauge": value}
    return out


def snapshot() -> Dict[str, Dict[str, float]]:
    """``summary()`` under the fleet naming: every percentile family in it
    carries ``n`` beside its p50/p95/p99."""
    return summary()


def reset() -> None:
    """Clear the stats, the latency histograms and the gauges, so a run
    after it reads like a fresh process."""
    with _lock:
        _stats.clear()
        _lat.clear()
        _gauges.clear()


def report() -> str:
    """``summary()`` as text, a line a label."""
    lines = ["device-pipeline timing:"]
    for label, s in summary().items():
        if "gauge" in s:
            lines.append(f"  {label}: {s['gauge']}")
        elif "p95_ms" in s:
            lines.append(
                f"  {label}: {s['count']} obs, p50 {s['p50_ms']:.1f}ms, "
                f"p95 {s['p95_ms']:.1f}ms, p99 {s['p99_ms']:.1f}ms, "
                f"max {s['max_ms']:.1f}ms"
            )
        else:
            lines.append(
                f"  {label}: {s['calls']} calls, mean {s['mean_s']*1e3:.1f}ms, "
                f"max {s['max_s']*1e3:.1f}ms, total {s['total_s']:.2f}s"
            )
    return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a block, written to ``log_dir`` for
    TensorBoard; the block runs untraced where the profiler cannot start."""
    import torch
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(log_dir))
    try:
        prof.start()
    except Exception:
        prof = None
    try:
        yield
    finally:
        if prof is not None:
            try:
                prof.stop()
            except Exception:
                pass
