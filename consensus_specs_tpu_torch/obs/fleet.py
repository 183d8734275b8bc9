"""Fleet aggregator: N worker snapshots merged into ONE observability
surface (the port's copy of consensus_specs_tpu/obs/fleet.py, the same
merge rules).

The serve fleet runs one ``VerificationService`` process per worker; each
ships ``obs/snapshot.py`` wire snapshots over the worker protocol, and
this module folds them into the single fleet-wide view the router's
``/metrics``, ``/healthz`` and ``/flightdump`` serve:

- **histograms** merge exactly (``hist.py`` fixed bounds: bucket counts
  add), keyed by their bare label: the fleet's ``serve.submit_to_result``
  IS the sum of every worker's, which is what lets ``obs/slo.py`` compute
  burn rates on merged bucket mass;
- **stat accumulators** merge by summing calls and seconds (max of max);
- **gauges** split by plane: ``serve.*`` instance gauges re-scope per
  worker through ``registry.node_label`` (``serve[w0].queue_depth`` and
  ``serve[w1].queue_depth`` publish side by side), counter-like gauges of
  the other planes (``bls.*``, ``flight.*``, ``device.*``, ``hist.*``)
  SUM across workers, and worker ``slo.*`` gauges are dropped: the fleet
  recomputes objective state from the MERGED histograms
  (``serve/fleet.py``), never averages worker verdicts;
- **flight journals** merge incrementally: every ingest appends only the
  events past the worker's last-seen sequence number, each stamped with
  its worker label, so a shed decision in the router and the ladder
  transition it caused in the worker reconstruct side by side.

The merged exposition is ``registry.render_prometheus`` over the merged
(stats, gauges, hists) triple: one renderer, one text format, whether
the process behind ``/metrics`` is a lone service or a fleet.
"""
import json
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from . import registry, snapshot
from .hist import Histogram

# worker gauges under these planes re-scope per worker via node_label
# (the serve[/chain[/process[ dynamic families; the JAX package's rule,
# so both aggregators merge alike. chain[ registers with the port's chain
# plane: a worker runs a service only, and ships no chain.* gauge);
# everything else is a process-wide counter-style gauge that sums across
# the fleet. process.* is instance state by definition: summing two
# workers' RSS reports a resident set nobody has
_INSTANCE_PLANES = ("serve.", "chain.", "process.")
# recomputed fleet-side from merged histograms, never merged from workers
_DROP_PREFIXES = ("slo.",)

# per-worker retained completed-trace wires (the stitched Chrome export
# reads these; the bound matches the worker tracer's own ring)
_SPAN_RING = 512


class FleetAggregator:
    """Merge-point for worker observability snapshots.

    ``ingest`` keeps the LATEST snapshot per worker (snapshots are
    cumulative process state, not deltas — merging the latest from each
    worker is exact) and appends newly-seen flight events to the merged
    journal. All reads build fresh merged structures; nothing here holds
    references into a worker's live state.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._snaps: Dict[str, Dict] = {}
        self._journal: List[Dict] = []
        self._last_seq: Dict[str, int] = {}
        self._last_rid: Dict[str, int] = {}
        # pid of the incarnation the watermarks belong to: a respawned
        # worker restarts its seq/rid counters from 1, so watermarks
        # keyed by label alone would silently drop the new process's
        # entire journal/span stream
        self._pids: Dict[str, int] = {}
        self._spans: Dict[str, "deque[Dict]"] = {}
        self.ingests = 0

    # -- ingest ---------------------------------------------------------------

    def ingest(self, worker: str, snap: Dict) -> None:
        """Store ``worker``'s latest snapshot (wire-version-checked) and
        absorb its new flight events / trace spans into the merged
        journal and span store. A snapshot arriving from a NEW pid under
        a known label is a respawned worker: its watermarks reset to 0
        first, so the fresh incarnation's restarted sequence numbers
        merge from the top instead of hiding below the old high water."""
        snapshot.check_version(snap)
        pid = int(snap.get("pid") or 0)
        with self._lock:
            prev_pid = self._pids.get(worker)
            if pid and prev_pid is not None and pid != prev_pid:
                self._last_seq[worker] = 0
                self._last_rid[worker] = 0
            if pid:
                self._pids[worker] = pid
            self._snaps[worker] = snap
            self.ingests += 1
            flight = snap.get("flight")
            if flight:
                last = self._last_seq.get(worker, 0)
                for event in flight.get("events", ()):
                    seq = int(event.get("seq", 0))
                    if seq > last:
                        stamped = dict(event)
                        stamped.setdefault("node", worker)
                        stamped["worker"] = worker
                        stamped["pid"] = pid
                        self._journal.append(stamped)
                        self._last_seq[worker] = seq
            spans = snap.get("spans")
            if spans:
                ring = self._spans.setdefault(worker,
                                              deque(maxlen=_SPAN_RING))
                last = self._last_rid.get(worker, 0)
                for tr in spans.get("traces", ()):
                    rid = int(tr.get("rid", 0))
                    if rid > last:
                        ring.append(dict(tr))
                        self._last_rid[worker] = rid
                        last = rid

    def _watermark(self, table: Dict[str, int], worker: str,
                   pid: Optional[int]) -> int:
        with self._lock:
            if pid is not None:
                known = self._pids.get(worker)
                if known is not None and int(pid) != known:
                    # the caller is asking on behalf of a NEW incarnation
                    # the aggregator has not ingested yet: its counters
                    # start over, so the delta cursor must be 0 — passing
                    # the old incarnation's high water would make the
                    # fresh worker ship nothing, forever
                    return 0
            return table.get(worker, 0)

    def last_seq(self, worker: str, pid: Optional[int] = None) -> int:
        """Highest flight-event sequence number already merged from
        ``worker`` — the router passes it back as ``flight_since`` so
        steady-state snapshots ship journal deltas, not the full ring.
        ``pid`` (the live handle's OS pid) guards the restart race: a
        pid the aggregator hasn't seen yet answers 0."""
        return self._watermark(self._last_seq, worker, pid)

    def last_rid(self, worker: str, pid: Optional[int] = None) -> int:
        """Span-stream analog of :meth:`last_seq` (``spans_since``)."""
        return self._watermark(self._last_rid, worker, pid)

    # -- merged reads ---------------------------------------------------------

    @property
    def workers(self) -> List[str]:
        with self._lock:
            return sorted(self._snaps)

    def worker_snapshot(self, worker: str) -> Optional[Dict]:
        with self._lock:
            return self._snaps.get(worker)

    def worker_hists(self, worker: str) -> Dict[str, Histogram]:
        """One worker's latency histograms, decoded (per-worker SLO burn
        attribution reads these)."""
        with self._lock:
            snap = self._snaps.get(worker)
        if snap is None:
            return {}
        return {label: snapshot.hist_from_wire(w)
                for label, w in snap.get("hists", {}).items()}

    def merged_hists(self) -> Dict[str, Histogram]:
        """Exact fleet-wide histograms: per label, the merge of every
        worker's wire histogram (observation counts sum, bucket mass
        sums)."""
        with self._lock:
            snaps = list(self._snaps.values())
        by_label: Dict[str, List[Dict]] = {}
        for snap in snaps:
            for label, wire in snap.get("hists", {}).items():
                by_label.setdefault(label, []).append(wire)
        return {label: snapshot.merge_hist_wires(wires)
                for label, wires in sorted(by_label.items())}

    def merged_stats(self) -> Dict[str, Dict]:
        with self._lock:
            snaps = list(self._snaps.values())
        by_label: Dict[str, List[Dict]] = {}
        for snap in snaps:
            for label, entry in snap.get("stats", {}).items():
                by_label.setdefault(label, []).append(entry)
        return {label: snapshot.merge_stat_entries(entries)
                for label, entries in sorted(by_label.items())}

    def merged_gauges(self) -> Dict[str, float]:
        """Worker gauges under the fleet merge rule (module docstring):
        instance planes re-scope per worker, counters sum, slo.* drops."""
        with self._lock:
            items = sorted(self._snaps.items())
        out: Dict[str, float] = {}
        for worker, snap in items:
            for label, value in snap.get("gauges", {}).items():
                if label.startswith(_DROP_PREFIXES):
                    continue
                if label.startswith(_INSTANCE_PLANES) and "[" not in label:
                    out[registry.node_label(label, worker)] = value
                else:
                    out[label] = out.get(label, 0.0) + value
        return out

    def merged_view(self, local_stats: Optional[Dict] = None,
                    local_gauges: Optional[Dict] = None,
                    local_hists: Optional[Dict] = None
                    ) -> Tuple[Dict, Dict, Dict]:
        """The (stats, gauges, hists) triple the Prometheus renderer
        consumes. ``local_*`` overlay the aggregator process's own state
        on top of the worker merge — but only where the router is the
        authority: ``fleet.*`` / ``slo.*`` gauges replace (they are
        router-computed), unknown keys add, and any other collision
        keeps the WORKER sum (e.g. the router dumping its own flight
        journal sets a local ``flight.events`` that must not clobber the
        fleet-summed counter — the merged scrape stays the exact merge).
        ``local_hists`` (the router process's own latency histograms —
        e.g. an end-to-end ``latency.gossip_to_head`` recorded by a
        consumer of the fleet's verdicts) MERGE exactly
        with the worker families: histogram observations are disjoint by
        construction, so a label collision sums bucket mass like any
        other fleet member's."""
        stats = self.merged_stats()
        gauges = self.merged_gauges()
        hists = self.merged_hists()
        if local_stats:
            for label, entry in local_stats.items():
                stats[label] = (snapshot.merge_stat_entries(
                    [stats[label], entry]) if label in stats else entry)
        if local_gauges:
            for label, value in local_gauges.items():
                if label.startswith(("fleet.", "slo.")) or label not in gauges:
                    gauges[label] = value
        if local_hists:
            for label, h in local_hists.items():
                hists[label] = (hists[label].merge(h) if label in hists
                                else h)
        return stats, gauges, hists

    def render_metrics(self, local_stats: Optional[Dict] = None,
                       local_gauges: Optional[Dict] = None,
                       local_hists: Optional[Dict] = None) -> str:
        """The fleet-wide ``/metrics`` body: the standard Prometheus
        renderer over the merged triple."""
        stats, gauges, hists = self.merged_view(local_stats, local_gauges,
                                                local_hists)
        return registry.render_prometheus(stats=stats, gauges=gauges,
                                          hists=hists)

    # -- merged time series + spans -------------------------------------------

    def worker_timeseries_wires(self) -> List[Dict]:
        """Every worker's latest TSDB wire (workers with the TSDB env
        unset ship no section and contribute nothing)."""
        with self._lock:
            items = sorted(self._snaps.items())
        return [snap["timeseries"] for _w, snap in items
                if snap.get("timeseries")]

    def merged_timeseries_wire(self, local_wire: Optional[Dict] = None
                               ) -> Dict:
        """ONE fleet-wide time-series wire: the exact merge of every
        worker's rings plus (when given) the router process's own store
        — the ``/timeseries`` body. The merge algebra
        (``obs/timeseries.py``: per-label max-sub wins, ties sum, hist
        deltas add) makes this bit-identical to a single store that had
        ingested every process's samples, which is what the split-feed
        property test pins."""
        from . import timeseries

        wires = ([local_wire] if local_wire else [])
        wires += self.worker_timeseries_wires()
        return timeseries.merge_wires(wires)

    def worker_span_sections(self) -> Dict[str, Dict]:
        """Per-worker stitching input for ``tracing.stitched_chrome``:
        ``{label: {"pid": os_pid, "traces": [wire traces]}}``."""
        with self._lock:
            return {worker: {"pid": self._pids.get(worker, 0),
                             "traces": [dict(tr) for tr in ring]}
                    for worker, ring in self._spans.items() if ring}

    # -- merged journal -------------------------------------------------------

    def journal_events(self, local_recorder=None) -> List[Dict]:
        """The merged flight journal: every worker's ingested events plus
        (when given) the aggregator process's own recorder — the router's
        shed/drain decisions interleaved with the worker transitions they
        caused. Ordered by ingest for workers, with local events appended
        in ring order (clocks are per-process perf counters and do not
        share an epoch; ``seq`` + provenance are the reconstruction keys,
        not ``t``)."""
        with self._lock:
            events = [dict(e) for e in self._journal]
        if local_recorder is not None:
            for e in local_recorder.events():
                stamped = dict(e)
                stamped["worker"] = stamped.get("node", "router")
                stamped.setdefault("node", "router")
                events.append(stamped)
        return events

    def journal_jsonl(self, local_recorder=None,
                      reason: str = "fleet_dump") -> str:
        """The merged journal as JSONL (one header line + one event per
        line) — the ``/flightdump`` body and the CI failure artifact."""
        events = self.journal_events(local_recorder)
        header = {
            "flight": "fleet-v1",
            "reason": reason,
            "workers": self.workers,
            "events": len(events),
        }
        lines = [json.dumps(header, sort_keys=True)]
        for e in events:
            if isinstance(e.get("t"), float):
                e["t"] = round(e["t"], 6)
            lines.append(json.dumps(e, sort_keys=True, default=repr))
        return "\n".join(lines) + "\n"
