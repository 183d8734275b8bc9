"""Cross-plane flight recorder: a bounded ring journal of WHY events (the
port's copy of consensus_specs_tpu/obs/flight.py).

Metrics say a degradation happened (``serve.backend_error`` ticked); the
journal says what led up to it. Planes journal small structured events
into one process-wide ring:

  serve: flush composition, cache and dedup answers, backend retries, and
         every degradation-ladder transition (RLC -> per-group -> oracle);
  vm:    program resolutions, assembly stalls, final-exp routes.

On a fault (the serve plane reaching the sequential-oracle rung, or any
belt-and-braces exception) the ring dumps itself to JSONL, and on demand
through ``dump()``. ``chrome_events`` turns the journal into instant
events on the Chrome trace timeline (pid 4), on the span view's clock.

Opt-in and zero-cost when off: the serve service captures
``maybe_recorder()`` at construction (None when
``CONSENSUS_SPECS_TPU_FLIGHT`` is unset, so every hot-path site is one
``is not None`` check), and the module-level ``note()`` of call-scale
sites is one env read. Ring size: ``CONSENSUS_SPECS_TPU_FLIGHT_RING``
(default 4096 events); dump path: ``CONSENSUS_SPECS_TPU_FLIGHT_DUMP``
(default ``flight_dump.jsonl``).
"""
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional

from . import fsio

FLIGHT_ENV = "CONSENSUS_SPECS_TPU_FLIGHT"
RING_ENV = "CONSENSUS_SPECS_TPU_FLIGHT_RING"
DUMP_ENV = "CONSENSUS_SPECS_TPU_FLIGHT_DUMP"

DEFAULT_RING = 4096
DEFAULT_DUMP = "flight_dump.jsonl"

# stable plane -> chrome tid mapping, the JAX package's, so both exports
# put a plane on the same row (new planes append)
PLANES = ("serve", "chain", "vm", "fleet", "lightclient")

# set by the fleet router in every worker process it spawns: dump paths
# get a `.{label}-pid{pid}` suffix so N workers (and the router) sharing
# one CONSENSUS_SPECS_TPU_FLIGHT_DUMP default never clobber each other's
# post-mortems
WORKER_ENV = "CONSENSUS_SPECS_TPU_FLEET_WORKER"


def resolve_dump_path(path: str) -> str:
    """Worker-disambiguated dump path: outside a fleet worker the path is
    returned untouched; inside one (``CONSENSUS_SPECS_TPU_FLEET_WORKER``
    set) the worker label and pid are suffixed before the extension:
    ``flight_dump.jsonl`` -> ``flight_dump.w0-pid1234.jsonl``."""
    label = (os.environ.get(WORKER_ENV) or "").strip()
    if not label:
        return path
    label = "".join(c for c in label if c.isalnum() or c in "_-") or "w"
    root, ext = os.path.splitext(path)
    return f"{root}.{label}-pid{os.getpid()}{ext or '.jsonl'}"


def enabled() -> bool:
    """Dynamic env read (the ``tracing.trace_enabled`` contract)."""
    return os.environ.get(FLIGHT_ENV, "0") not in ("", "0")


class FlightRecorder:
    """Bounded, lock-cheap structured-event journal.

    One plain lock per ``note()`` — journal sites are flush/batch/program
    scale, not per-limb scale, and the critical section is an append to a
    preallocated deque. ``clock`` is injectable for deterministic tests.

    ``node`` stamps every journaled event (a top-level ``node`` key, not
    payload data) so per-instance recorders stay attributable after their
    journals are merged or dumped side by side.
    """

    def __init__(self, capacity: int = DEFAULT_RING,
                 clock=time.perf_counter, node: Optional[str] = None):
        assert capacity > 0
        self._clock = clock
        self.node = node
        self._lock = threading.Lock()
        self._ring: "deque[Dict]" = deque(maxlen=capacity)
        self._seq = 0
        self._dropped = 0
        self._dumps = 0

    # -- recording -----------------------------------------------------------

    def note(self, plane: str, kind: str, **data) -> None:
        t = self._clock()
        event = {
            "seq": 0,
            "t": t,
            "plane": plane,
            "kind": kind,
            "data": data,
        }
        if self.node is not None:
            event["node"] = self.node
        with self._lock:
            self._seq += 1
            event["seq"] = self._seq
            if len(self._ring) == self._ring.maxlen:
                self._dropped += 1
            self._ring.append(event)

    # -- reading -------------------------------------------------------------

    def events(self) -> List[Dict]:
        with self._lock:
            return [dict(e) for e in self._ring]

    def counters(self) -> Dict[str, int]:
        with self._lock:
            return {
                "events": self._seq,
                "retained": len(self._ring),
                "dropped": self._dropped,
                "dumps": self._dumps,
            }

    def export_gauges(self) -> None:
        from ..ops import profiling

        c = self.counters()
        profiling.set_gauge("flight.events", c["events"])
        profiling.set_gauge("flight.dropped", c["dropped"])
        profiling.set_gauge("flight.dumps", c["dumps"])

    # -- dumping -------------------------------------------------------------

    def to_jsonl(self, reason: str = "on_demand") -> str:
        """The journal as JSONL text: one header line (counters + reason),
        then one event per line in ring order."""
        with self._lock:
            events = [dict(e) for e in self._ring]
            header = {
                "flight": "v1",
                "reason": reason,
                "events": self._seq,
                "retained": len(events),
                "dropped": self._dropped,
            }
            if self.node is not None:
                header["node"] = self.node
        lines = [json.dumps(header, sort_keys=True)]
        for e in events:
            e["t"] = round(e["t"], 6)
            lines.append(json.dumps(e, sort_keys=True, default=repr))
        return "\n".join(lines) + "\n"

    def dump(self, path: Optional[str] = None,
             reason: str = "on_demand") -> str:
        """Write the JSONL journal atomically; returns the (worker-
        disambiguated, see :func:`resolve_dump_path`) path."""
        if path is None:
            path = os.environ.get(DUMP_ENV, DEFAULT_DUMP)
        path = resolve_dump_path(path)
        fsio.atomic_write_text(path, self.to_jsonl(reason=reason))
        with self._lock:
            self._dumps += 1
        self.export_gauges()
        return path

    def dump_on_fault(self, reason: str) -> Optional[str]:
        """The automatic post-mortem: journal itself + a fault marker,
        dumped to the configured path. Never raises — a broken dump must
        not worsen the fault being recorded."""
        try:
            self.note("flight", "fault", reason=reason)
            return self.dump(reason=reason)
        except Exception:
            return None

    def chrome_events(self, us_fn) -> List[Dict]:
        """Instant ("i") events on pid 4, one row per plane, for the
        Chrome trace export — the journal on the span timeline's clock."""
        events = self.events()
        if not events:
            return []
        out: List[Dict] = [
            {"ph": "M", "name": "process_name", "pid": 4,
             "args": {"name": "flight-recorder"}},
        ]
        tids: Dict[str, int] = {}
        for e in events:
            plane = e["plane"]
            tid = tids.get(plane)
            if tid is None:
                tid = tids[plane] = (PLANES.index(plane) + 1
                                     if plane in PLANES else len(PLANES)
                                     + len(tids) + 1)
                out.append({
                    "ph": "M", "name": "thread_name", "pid": 4, "tid": tid,
                    "args": {"name": f"flight-{plane}"},
                })
            args = dict(e["data"], seq=e["seq"])
            if "node" in e:
                args["node"] = e["node"]
            out.append({
                "name": f"{plane}.{e['kind']}", "cat": "flight", "ph": "i",
                "s": "t", "pid": 4, "tid": tid, "ts": us_fn(e["t"]),
                "args": args,
            })
        return out


# -- process-global recorder --------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[FlightRecorder] = None


def _ring_capacity() -> int:
    """CONSENSUS_SPECS_TPU_FLIGHT_RING, defaulting past malformed values
    — a typo'd ring size must degrade to the default, never crash the
    service construction that armed the recorder."""
    raw = os.environ.get(RING_ENV, "")
    try:
        n = int(raw)
    except ValueError:
        return DEFAULT_RING
    return n if n > 0 else DEFAULT_RING


def global_recorder() -> FlightRecorder:
    global _global
    with _global_lock:
        if _global is None:
            _global = FlightRecorder(capacity=_ring_capacity())
        return _global


def maybe_recorder() -> Optional[FlightRecorder]:
    """The global recorder when enabled, else None — the exact value the
    serve service stores, so the disabled path is a None check."""
    return global_recorder() if enabled() else None


def reset_global() -> None:
    global _global
    with _global_lock:
        _global = None


def note(plane: str, kind: str, **data) -> None:
    """Call-scale journal helper (program resolutions, final-exp routes):
    one env read when disabled. Hot-path sites store ``maybe_recorder()`` at
    construction instead."""
    rec = maybe_recorder()
    if rec is not None:
        rec.note(plane, kind, **data)


def earliest_timestamp() -> Optional[float]:
    """Oldest retained event time (perf_counter seconds), for the trace
    exporter's epoch rewind; None when disabled/empty."""
    if not enabled() or _global is None:
        return None
    events = _global.events()
    return min((e["t"] for e in events), default=None)


def chrome_events(us_fn) -> List[Dict]:
    """Module-level hook ``tracing.dump_trace`` composes: empty when the
    recorder is disabled or never journaled."""
    if not enabled() or _global is None:
        return []
    return _global.chrome_events(us_fn)
