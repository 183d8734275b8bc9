"""Span-based request tracing for the serve pipeline and the VM
execution plane (the port's copy of consensus_specs_tpu/obs/tracing.py,
with the fleet's cross-process stitching).

Every accepted ``VerificationService.submit()`` gets a ``RequestTrace``
that the pipeline stages stamp with spans: ``queue_wait`` (submit to
pulled by the prep stage), ``prep`` (input codec), ``device`` (the flush's
verification), ``combine`` (the RLC combined check, bisection included)
and ``finalize`` (cache write and future resolution). Completed traces
live in a bounded ring; anything slower than the running p99 is pinned
into a separate exemplar ring so the slow tail survives ring churn.

Opt-in and zero-cost when off: the service holds ``None`` instead of a
tracer (one ``is not None`` per stage), and ``vm.execute`` checks
:func:`trace_enabled`, a plain env read, before recording anything.
Enable with ``CONSENSUS_SPECS_TPU_TRACE=1`` or pass a ``Tracer`` to the
service.

Export is Chrome trace-event JSON (chrome://tracing or Perfetto):
pipeline spans on pid 1 (one row per request), VM program executions on
pid 2, the device-occupancy lanes on pid 3 and the flight journal on
pid 4 (``dump_trace``), plus the per-program registry
(``obs/programs.py``) under the top-level ``programRegistry`` key.
"""
import itertools
import json
import os
import threading
import time
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import registry as _registry

TRACE_ENV = "CONSENSUS_SPECS_TPU_TRACE"

# the span stages the serve and chain planes stamp, from the registry
# (obs/registry.py SPAN_STAGES); `ingress` rides a request trace when its
# submit carried a birth timestamp
STAGES = _registry.SPAN_STAGES["serve"]
CHAIN_STAGES = _registry.SPAN_STAGES["chain"]
LATENCY_STAGES = _registry.SPAN_STAGES["latency"]


def trace_enabled() -> bool:
    """Dynamic env check: flipping the env after import takes effect on
    the next service construction or VM execution."""
    return os.environ.get(TRACE_ENV, "0") not in ("", "0")


class RequestTrace:
    """One request's journey through the pipeline.

    Spans append WITHOUT a lock: every stage is a single writer (submit
    thread -> prep thread -> device thread, strictly sequenced by the
    service's queues), so only the tracer's shared rings need locking.
    """

    __slots__ = ("rid", "kind", "n_keys", "t_submit", "spans", "total_s",
                 "ok", "pinned", "flow", "flows")

    def __init__(self, rid: int, kind: str, n_keys: int, t_submit: float,
                 flow: Optional[int] = None):
        self.rid = rid
        self.kind = kind
        self.n_keys = n_keys
        self.t_submit = t_submit
        self.spans: List[Tuple[str, float, float]] = []
        self.total_s: Optional[float] = None
        self.ok: Optional[bool] = None
        self.pinned = False
        # flow linkage: `flow` is the ingress trace id a serve request
        # carries (the Chrome flow-event id emitted at its finalize);
        # `flows` are ids a downstream batch trace absorbs (the flow
        # arrows terminate at its last stage)
        self.flow = flow
        self.flows: Tuple[int, ...] = ()

    def span_names(self):
        return {name for name, _, _ in self.spans}

    def to_dict(self) -> Dict:
        return {
            "rid": self.rid,
            "kind": self.kind,
            "n_keys": self.n_keys,
            "ok": self.ok,
            "pinned": self.pinned,
            "total_ms": (round(self.total_s * 1e3, 3)
                         if self.total_s is not None else None),
            "spans": {name: round((b - a) * 1e3, 3)
                      for name, a, b in self.spans},
        }


class Tracer:
    """Bounded-memory span collector with slow-request exemplar capture.

    ``capacity`` bounds the completed-trace ring AND the VM-execution ring;
    ``exemplar_capacity`` bounds the pinned slow tail. ``clock`` is
    injectable so a Chrome export can be made deterministic.
    """

    # refresh the running-p99 estimate every this many finishes (sorting
    # the window per finish would tax the enabled hot path needlessly)
    _P99_REFRESH = 32

    def __init__(self, capacity: int = 512, exemplar_capacity: int = 32,
                 clock=time.perf_counter):
        assert capacity > 0 and exemplar_capacity > 0
        self.clock = clock
        self._t0 = clock()  # trace epoch: chrome ts are offsets from here
        self._lock = threading.Lock()
        self._ids = itertools.count(1)
        self._ring: "deque[RequestTrace]" = deque(maxlen=capacity)
        self._exemplars: "deque[RequestTrace]" = deque(
            maxlen=exemplar_capacity)
        self._totals: "deque[float]" = deque(maxlen=1024)  # p99 window
        self._p99 = 0.0
        self._finished = 0
        self._executions: "deque[Dict]" = deque(maxlen=capacity)

    # -- recording (service / vm hooks) -------------------------------------

    def begin(self, kind: str, n_keys: int,
              t_submit: Optional[float] = None,
              flow: Optional[int] = None) -> RequestTrace:
        if t_submit is None:
            t_submit = self.clock()
        return RequestTrace(next(self._ids), kind, n_keys, t_submit,
                            flow=flow)

    def span(self, trace: RequestTrace, name: str, t0: float,
             t1: float) -> None:
        trace.spans.append((name, t0, t1))

    def span_many(self, traces, name: str, t0: float, t1: float) -> None:
        """Stamp one shared stage interval onto a whole micro-batch
        (batch stages cost the same wall time for every member)."""
        for tr in traces:
            if tr is not None:
                tr.spans.append((name, t0, t1))

    def finish(self, trace: RequestTrace, ok: bool,
               t_done: Optional[float] = None) -> None:
        if t_done is None:
            t_done = self.clock()
        trace.ok = bool(ok)
        trace.total_s = t_done - trace.t_submit
        with self._lock:
            # a trace begun before this tracer existed (explicit t_submit)
            # must not export negative timestamps — rewind the epoch; an
            # `ingress` span's birth timestamp can predate even t_submit
            # (the item waited at the gossip layer), so the earliest span
            # start participates in the rewind too
            t_first = min((a for _name, a, _b in trace.spans),
                          default=trace.t_submit)
            if min(trace.t_submit, t_first) < self._t0:
                self._t0 = min(trace.t_submit, t_first)
            self._finished += 1
            # pin BEFORE folding this total into the window: "over the
            # RUNNING p99" means the p99 of everything before this request
            pin = bool(self._totals) and trace.total_s >= self._p99
            self._totals.append(trace.total_s)
            if self._p99 == 0.0 or self._finished % self._P99_REFRESH == 1:
                ordered = sorted(self._totals)
                self._p99 = ordered[min(len(ordered) - 1,
                                        (99 * len(ordered)) // 100)]
            if pin:
                trace.pinned = True
                self._exemplars.append(trace)
            self._ring.append(trace)

    def note_execution(self, *, steps: int, regs: int, batch, sharded: bool,
                       t0: float, seconds: float) -> None:
        """One VM program execution (vm.execute hook)."""
        with self._lock:
            # the FIRST traced execution may predate the lazily-created
            # global tracer (t0 is captured before the device call, and
            # that call can include a seconds-long assembly): rewind the
            # epoch so Perfetto never clamps/drops the most expensive
            # event for sitting before the trace origin
            if t0 < self._t0:
                self._t0 = t0
            self._executions.append({
                "steps": int(steps),
                "regs": int(regs),
                "batch": list(batch),
                "sharded": bool(sharded),
                "t0": t0,
                "seconds": seconds,
            })

    # -- reading ------------------------------------------------------------

    def completed(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._ring)

    def exemplars(self) -> List[RequestTrace]:
        with self._lock:
            return list(self._exemplars)

    def executions(self) -> List[Dict]:
        with self._lock:
            return [dict(e) for e in self._executions]

    def running_p99_s(self) -> float:
        with self._lock:
            return self._p99

    def finished_total(self) -> int:
        """Monotone count of finished traces — unlike ``completed()``,
        not capped by the ring, so scaled runs can report how many
        requests were traced vs how many the ring still holds."""
        with self._lock:
            return self._finished

    # -- chrome trace-event export -------------------------------------------

    def _us(self, t: float) -> float:
        return round((t - self._t0) * 1e6, 3)

    def to_chrome(self) -> Dict:
        """Chrome trace-event JSON object (load in chrome://tracing or
        Perfetto). Pipeline spans are complete ("X") events on pid 1, one
        tid per request; VM executions are "X" events on pid 2; the
        per-program registry rides the (spec-sanctioned) extra top-level
        key ``programRegistry``."""
        from . import programs

        with self._lock:
            traces = list(self._ring)
            execs = list(self._executions)
            exemplars = list(self._exemplars)
            p99_s = self._p99
            finished = self._finished
        events: List[Dict] = [
            {"ph": "M", "name": "process_name", "pid": 1,
             "args": {"name": "serve-pipeline"}},
            {"ph": "M", "name": "process_name", "pid": 2,
             "args": {"name": "vm-programs"}},
        ]
        for tr in traces:
            events.append({
                "ph": "M", "name": "thread_name", "pid": 1, "tid": tr.rid,
                "args": {"name": f"req-{tr.rid} {tr.kind} k={tr.n_keys}"},
            })
            for name, a, b in tr.spans:
                args = {"kind": tr.kind, "n_keys": tr.n_keys}
                if name == "finalize":
                    args.update(ok=tr.ok, pinned=tr.pinned,
                                total_ms=round((tr.total_s or 0.0) * 1e3, 3))
                events.append({
                    "name": name, "cat": "serve", "ph": "X",
                    "pid": 1, "tid": tr.rid,
                    "ts": self._us(a),
                    "dur": round(max(0.0, b - a) * 1e6, 3),
                    "args": args,
                })
            # flow links: a serve request carrying an ingress flow id
            # STARTS the flow at the end of its last span (finalize); a
            # trace that absorbed flow ids FINISHES each at the start of
            # its last span
            if tr.spans:
                if tr.flow is not None:
                    events.append({
                        "name": "gossip_to_head", "cat": "latency",
                        "ph": "s", "id": tr.flow, "pid": 1, "tid": tr.rid,
                        "ts": self._us(max(b for _n, _a, b in tr.spans)),
                    })
                t_last_start = max(a for _n, a, _b in tr.spans)
                for fid in tr.flows:
                    events.append({
                        "name": "gossip_to_head", "cat": "latency",
                        "ph": "f", "bp": "e", "id": fid,
                        "pid": 1, "tid": tr.rid,
                        "ts": self._us(t_last_start),
                    })
        for ex in execs:
            events.append({
                "name": (f"vm[steps={ex['steps']},regs={ex['regs']},"
                         f"batch={tuple(ex['batch'])}]"),
                "cat": "vm", "ph": "X", "pid": 2, "tid": 1,
                "ts": self._us(ex["t0"]),
                "dur": round(max(0.0, ex["seconds"]) * 1e6, 3),
                "args": {"steps": ex["steps"], "regs": ex["regs"],
                         "batch": ex["batch"], "sharded": ex["sharded"]},
            })
        return {
            "traceEvents": events,
            "displayTimeUnit": "ms",
            "programRegistry": programs.registry_snapshot(),
            "otherData": {
                # requests = spans present in this export (ring-bounded);
                # finished_total = every trace ever finished — when they
                # differ, the ring dropped the oldest (finished_total -
                # requests) requests' spans
                "requests": len(traces),
                "finished_total": finished,
                "exemplars": [t.to_dict() for t in exemplars],
                "running_p99_ms": round(p99_s * 1e3, 3),
            },
        }

    def dump(self, path: str) -> str:
        from . import fsio

        return fsio.atomic_write_text(
            path, json.dumps(self.to_chrome(), indent=1, sort_keys=True))


# -- cross-process span stitching --------------------------------------------
#
# A fleet worker's spans would die at the process boundary. The worker
# snapshot ships COMPLETED traces as JSON-safe wire dicts (`trace_to_wire`
# / `wire_spans`, rid-delta'd the way flight events are seq-delta'd), and
# the aggregator re-emits them under per-worker pids
# (`worker_chrome_events`) in ONE stitched document (`stitched_chrome`).
# Timestamps stay comparable because `time.perf_counter` is
# CLOCK_MONOTONIC on Linux, one epoch for every process on the host, and
# the stitch rewinds the router tracer's origin to the earliest worker
# span, the rule `dump_trace` applies to the device and flight lanes. Flow
# ids survive the boundary: the router forwards each submit's `flow_id`
# over the worker protocol and the worker's finalize emits the flow START
# on its own pid. The wire form is the JAX package's.

# worker lanes start here: pid 1-4 are the router's own lanes (serve /
# vm / devices / flight), workers take 100+index in snapshot order
WORKER_PID_BASE = 100


def trace_to_wire(tr: RequestTrace) -> Dict:
    """One completed trace as a JSON-safe dict (the snapshot carrier)."""
    return {
        "rid": tr.rid,
        "kind": tr.kind,
        "n_keys": tr.n_keys,
        "t_submit": tr.t_submit,
        "ok": tr.ok,
        "pinned": tr.pinned,
        "total_s": tr.total_s,
        "flow": tr.flow,
        "flows": list(tr.flows),
        "spans": [[name, a, b] for name, a, b in tr.spans],
    }


def wire_spans(tracer: Tracer, since_rid: int = 0) -> List[Dict]:
    """Completed traces with ``rid`` past ``since_rid`` (the aggregator
    passes its high-water rid back, so steady-state snapshots ship span
    DELTAS — same incremental contract as the flight journal)."""
    return [trace_to_wire(tr) for tr in tracer.completed()
            if tr.rid > int(since_rid)]


def earliest_wire_timestamp(traces: List[Dict]) -> Optional[float]:
    times = []
    for tr in traces:
        times.append(float(tr.get("t_submit", 0.0)))
        for _name, a, _b in tr.get("spans", ()):
            times.append(float(a))
    return min(times) if times else None


def worker_chrome_events(traces: List[Dict], pid: int, label: str,
                         us) -> List[Dict]:
    """One worker's wire traces as Chrome events on its own pid —
    the same span/flow shapes ``to_chrome`` emits for the router's
    requests, so the stitched document reads as one pipeline."""
    events: List[Dict] = [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": f"worker {label}"}},
    ]
    for tr in traces:
        rid = int(tr.get("rid", 0))
        events.append({
            "ph": "M", "name": "thread_name", "pid": pid, "tid": rid,
            "args": {"name": f"req-{rid} {tr.get('kind')} "
                             f"k={tr.get('n_keys')}"},
        })
        spans = [(name, float(a), float(b))
                 for name, a, b in tr.get("spans", ())]
        for name, a, b in spans:
            args = {"kind": tr.get("kind"), "n_keys": tr.get("n_keys"),
                    "worker": label}
            if name == "finalize":
                args.update(ok=tr.get("ok"), pinned=tr.get("pinned"),
                            total_ms=round(
                                (tr.get("total_s") or 0.0) * 1e3, 3))
            events.append({
                "name": name, "cat": "serve", "ph": "X",
                "pid": pid, "tid": rid,
                "ts": us(a),
                "dur": round(max(0.0, b - a) * 1e6, 3),
                "args": args,
            })
        if spans:
            if tr.get("flow") is not None:
                events.append({
                    "name": "gossip_to_head", "cat": "latency",
                    "ph": "s", "id": int(tr["flow"]), "pid": pid,
                    "tid": rid,
                    "ts": us(max(b for _n, _a, b in spans)),
                })
            t_last_start = max(a for _n, a, _b in spans)
            for fid in tr.get("flows", ()):
                events.append({
                    "name": "gossip_to_head", "cat": "latency",
                    "ph": "f", "bp": "e", "id": int(fid),
                    "pid": pid, "tid": rid,
                    "ts": us(t_last_start),
                })
    return events


def stitched_chrome(tracer: Tracer, worker_sections: Dict[str, Dict]) -> Dict:
    """ONE Chrome document from the router tracer plus per-worker span
    sections (``{label: {"pid": os_pid, "traces": [wire traces]}}`` —
    what ``obs/fleet.FleetAggregator.worker_span_sections`` returns).
    Workers render on pids ``WORKER_PID_BASE + i`` in sorted-label order
    (the worker's OS pid rides the process_name metadata via its label
    row in ``otherData.workerPids``), and every flow id the router
    forwarded joins the worker-side START to the router-side FINISH."""
    earliest = None
    for sec in worker_sections.values():
        t = earliest_wire_timestamp(sec.get("traces", ()))
        if t is not None:
            earliest = t if earliest is None else min(earliest, t)
    if earliest is not None:
        with tracer._lock:
            tracer._t0 = min(tracer._t0, earliest)
    doc = tracer.to_chrome()
    worker_pids = {}
    for i, label in enumerate(sorted(worker_sections)):
        sec = worker_sections[label]
        pid = WORKER_PID_BASE + i
        worker_pids[label] = {"pid": pid,
                              "os_pid": int(sec.get("pid") or 0)}
        doc["traceEvents"].extend(worker_chrome_events(
            sec.get("traces", ()), pid, label, tracer._us))
    doc["otherData"]["workerPids"] = worker_pids
    return doc


# -- process-global tracer ---------------------------------------------------

_global_lock = threading.Lock()
_global: Optional[Tracer] = None


def global_tracer() -> Tracer:
    """The process tracer (created on first use); what ``vm.execute`` and
    env-enabled services record into, and what ``dump_trace`` exports."""
    global _global
    with _global_lock:
        if _global is None:
            _global = Tracer()
        return _global


def maybe_tracer() -> Optional[Tracer]:
    """The global tracer when tracing is enabled, else None — the exact
    value the service stores, so the disabled path is a None check."""
    return global_tracer() if trace_enabled() else None


def reset_global() -> None:
    """Drop the global tracer (tests / multi-run benches)."""
    global _global
    with _global_lock:
        _global = None


def dump_trace(path: str) -> str:
    """Export the global tracer's rings as Chrome trace-event JSON, with
    the per-device occupancy timeline (obs/devices.py, pid 3) and the
    flight-recorder journal (obs/flight.py, pid 4 instants) composed in on
    the tracer's clock. Disabled or empty lanes contribute nothing
    (``Tracer.dump`` alone is the lane-free export)."""
    from . import devices, flight

    tracer = global_tracer()
    # epoch rewind for the composed lanes: a journal/occupancy event can
    # predate the lazily-created tracer (e.g. a program resolution noted
    # before the first traced execution) — same rule note_execution
    # applies to its own early events, so no lane exports negative ts
    earliest = min(
        (t for t in (devices.earliest_timestamp(),
                     flight.earliest_timestamp()) if t is not None),
        default=None)
    if earliest is not None:
        with tracer._lock:
            tracer._t0 = min(tracer._t0, earliest)
    doc = tracer.to_chrome()
    doc["traceEvents"].extend(devices.chrome_events(tracer._us))
    doc["traceEvents"].extend(flight.chrome_events(tracer._us))
    from . import fsio

    return fsio.atomic_write_text(
        path, json.dumps(doc, indent=1, sort_keys=True))


def dump_stitched_trace(path: str, worker_sections: Dict[str, Dict]) -> str:
    """`dump_trace` plus the fleet's cross-process span sections: the
    router's own lanes (pids 1-4) AND every worker's request spans on
    per-worker pids, flow ids joining across the process boundary.
    ``serve/fleet.FleetRouter.dump_trace`` is the caller."""
    from . import devices, flight, fsio

    tracer = global_tracer()
    earliest = [t for t in (devices.earliest_timestamp(),
                            flight.earliest_timestamp()) if t is not None]
    for sec in worker_sections.values():
        t = earliest_wire_timestamp(sec.get("traces", ()))
        if t is not None:
            earliest.append(t)
    if earliest:
        with tracer._lock:
            tracer._t0 = min(tracer._t0, min(earliest))
    doc = stitched_chrome(tracer, worker_sections)
    doc["traceEvents"].extend(devices.chrome_events(tracer._us))
    doc["traceEvents"].extend(flight.chrome_events(tracer._us))
    return fsio.atomic_write_text(
        path, json.dumps(doc, indent=1, sort_keys=True))
