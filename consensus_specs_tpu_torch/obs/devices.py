"""Per-device occupancy ledger: who was busy, when, and how much (the
port's copy of consensus_specs_tpu/obs/devices.py).

- ``ops/vm.execute`` notes every program run on the lane of its device:
  the CUDA device index, or ``cpu`` for the plain path;
- the serve service's PREP stage notes its input-codec time on the
  ``host`` lane, so the prep-vs-device pipeline overlap shows as two
  lanes with overlapping busy intervals.

Each lane keeps its busy seconds (the union of its intervals, so time in
which two threads were busy on one lane counts once) plus a bounded ring of recent
``(t0, t1, label)`` intervals, the busy/idle timeline, exported as an
occupancy lane (pid 3) in the Chrome trace (``tracing.dump_trace``).
Utilization gauges publish per lane through the dynamic ``device[<lane>]``
family plus the ``device.count`` / ``device.busy_s`` statics.

On by default (one lock at device-call scale, never per submit);
``CONSENSUS_SPECS_TPU_DEVICES=0`` turns it off, and then
``maybe_ledger()`` returns None so every note site skips on a None check.
"""
import bisect
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

DEVICES_ENV = "CONSENSUS_SPECS_TPU_DEVICES"

HOST_LANE = "host"  # the serve service's prep stage (not a device)

# per-lane interval ring: enough for a bench run's flushes; older busy
# time stays in the cumulative counter when the ring churns
INTERVAL_CAPACITY = 1024


def enabled() -> bool:
    """Dynamic env read, same contract as ``tracing.trace_enabled`` —
    flipping the env takes effect on the next note/snapshot."""
    return os.environ.get(DEVICES_ENV, "1") not in ("", "0")


class _Lane:
    """One lane's record. ``busy_s`` is the length of the UNION of its
    intervals: two threads busy on one lane at once (the serve service's
    two stages both run programs on the card) count that time once.
    Intervals merge into a window of the latest disjoint spans; a span
    that leaves the window keeps its length in ``busy_s`` and takes no
    further merges."""

    __slots__ = ("busy_s", "events", "intervals", "_starts", "_ends")

    def __init__(self):
        self.busy_s = 0.0
        self.events = 0
        self.intervals: "deque[Tuple[float, float, str]]" = deque(
            maxlen=INTERVAL_CAPACITY)
        self._starts: List[float] = []  # disjoint spans, sorted
        self._ends: List[float] = []

    def add(self, t0: float, t1: float, label: str) -> None:
        self.events += 1
        self.intervals.append((t0, t1, label))
        starts, ends = self._starts, self._ends
        # the spans that meet [t0, t1] are j .. i-1
        i = bisect.bisect_right(starts, t1)
        j = bisect.bisect_left(ends, t0)
        if j < i:
            lo, hi = min(t0, starts[j]), max(t1, ends[i - 1])
            self.busy_s -= sum(ends[k] - starts[k] for k in range(j, i))
        else:
            lo, hi = t0, t1
        starts[j:i] = [lo]
        ends[j:i] = [hi]
        self.busy_s += hi - lo
        if len(starts) > INTERVAL_CAPACITY:
            del starts[0], ends[0]


class DeviceLedger:
    """Busy-interval accumulator keyed by lane (device index or 'host')."""

    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._lock = threading.Lock()
        self._t_start = clock()
        self._lanes: Dict[object, _Lane] = {}

    # -- recording -----------------------------------------------------------

    def note_busy(self, lane, t0: float, t1: float, label: str = "") -> None:
        """One busy interval on ``lane`` (int device index or 'host')."""
        if t1 < t0:
            t0, t1 = t1, t0
        with self._lock:
            entry = self._lanes.get(lane)
            if entry is None:
                entry = self._lanes[lane] = _Lane()
            entry.add(t0, t1, label)

    def note_execution(self, device, t0: float, seconds: float,
                       label: str = "vm") -> None:
        """One VM program execution, busy on the lane of its
        ``torch.device``: the CUDA device index (the current device when
        the device names none), or the device type for another device."""
        self.note_busy(lane_of(device), t0, t0 + seconds, label)

    # -- reading -------------------------------------------------------------

    @staticmethod
    def _lane_key(lane) -> str:
        return str(lane)

    def utilization(self, now: Optional[float] = None) -> Dict[str, float]:
        if now is None:
            now = self._clock()
        elapsed = max(1e-9, now - self._t_start)
        with self._lock:
            return {
                self._lane_key(lane): entry.busy_s / elapsed
                for lane, entry in self._lanes.items()
            }

    def snapshot(self, now: Optional[float] = None) -> Dict:
        """The serve bench JSON's ``devices`` section."""
        if now is None:
            now = self._clock()
        elapsed = max(1e-9, now - self._t_start)
        with self._lock:
            lanes = {
                self._lane_key(lane): {
                    "busy_s": round(entry.busy_s, 4),
                    "utilization": round(entry.busy_s / elapsed, 4),
                    "events": entry.events,
                }
                for lane, entry in sorted(self._lanes.items(),
                                          key=lambda kv: str(kv[0]))
            }
        return {"elapsed_s": round(elapsed, 3), "lanes": lanes}

    def timeline(self) -> List[Tuple[str, str, float, float]]:
        """Recent busy intervals: (lane, label, t0, t1), lane-grouped —
        the Chrome occupancy lane's source."""
        with self._lock:
            out = []
            for lane, entry in sorted(self._lanes.items(),
                                      key=lambda kv: str(kv[0])):
                for t0, t1, label in entry.intervals:
                    out.append((self._lane_key(lane), label, t0, t1))
            return out

    def export_gauges(self) -> None:
        """Publish ``device.count``/``device.busy_s`` + per-lane
        utilization through the dynamic ``device[<lane>]`` family."""
        from ..ops import profiling

        util = self.utilization()
        with self._lock:
            total_busy = sum(e.busy_s for e in self._lanes.values())
            n = len(self._lanes)
        profiling.set_gauge("device.count", n)
        profiling.set_gauge("device.busy_s", total_busy)
        for lane, u in sorted(util.items()):
            profiling.set_gauge(f"device[{lane}]", u)


def lane_of(device):
    """A ``torch.device``'s lane key: the CUDA index, or the type."""
    import torch

    device = torch.device(device)
    if device.type != "cuda":
        return device.type
    return device.index if device.index is not None \
        else torch.cuda.current_device()


# -- process-global ledger ----------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[DeviceLedger] = None


def global_ledger() -> DeviceLedger:
    global _global
    with _global_lock:
        if _global is None:
            _global = DeviceLedger()
        return _global


def maybe_ledger() -> Optional[DeviceLedger]:
    """The global ledger when enabled, else None: note sites guard on a
    plain None check."""
    return global_ledger() if enabled() else None


def reset_global() -> None:
    """Fresh ledger (a bench run resets it so utilization denominators
    start at the run, not at process birth)."""
    global _global
    with _global_lock:
        _global = None


def earliest_timestamp() -> Optional[float]:
    """Oldest retained interval start (perf_counter seconds), for the
    trace exporter's epoch rewind; None when disabled/empty."""
    if not enabled() or _global is None:
        return None
    timeline = _global.timeline()
    return min((t0 for _l, _lb, t0, _t1 in timeline), default=None)


def chrome_events(us_fn) -> List[Dict]:
    """The occupancy lane for a Chrome trace export: one pid-3 row per
    lane, one complete ("X") event per busy interval. ``us_fn`` maps
    perf_counter seconds to trace microseconds (the exporting tracer's
    epoch). Empty when the ledger is disabled or never recorded."""
    if not enabled() or _global is None:
        return []
    timeline = _global.timeline()
    if not timeline:
        return []
    events: List[Dict] = [
        {"ph": "M", "name": "process_name", "pid": 3,
         "args": {"name": "device-occupancy"}},
    ]
    tids: Dict[str, int] = {}
    for lane, label, t0, t1 in timeline:
        tid = tids.get(lane)
        if tid is None:
            tid = tids[lane] = len(tids) + 1
            events.append({
                "ph": "M", "name": "thread_name", "pid": 3, "tid": tid,
                "args": {"name": (f"device-{lane}" if lane != HOST_LANE
                                  else "host-prep")},
            })
        events.append({
            "name": label or "busy", "cat": "device", "ph": "X",
            "pid": 3, "tid": tid, "ts": us_fn(t0),
            "dur": round(max(0.0, t1 - t0) * 1e6, 3),
            "args": {"lane": lane},
        })
    return events
