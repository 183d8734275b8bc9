"""Serve-plane observability: queue depth, batch occupancy, cache hit
rate, and submit->result latency percentiles (the port's copy of
consensus_specs_tpu/serve/metrics.py).

Everything is exported through ``ops/profiling`` (gauges and
``record_latency``) so ``profiling.summary()``, and every bench JSON line
that attaches it, carries the serving numbers. The backend's counters
(``PREP_STATS``, ``RLC_STATS``) are read from the port's
``ops/bls_backend`` through ``sys.modules``.
"""
import sys
import threading
from typing import Dict, Optional

from ..obs.registry import node_label
from ..ops import profiling

# resolved lazily through sys.modules: a service wrapping a lightweight
# test or oracle backend never pays the real backend's module load just to
# read its process-global counters; if the module is absent, the counters
# are necessarily still zero
_BACKEND_MOD = __package__.rsplit(".", 1)[0] + ".ops.bls_backend"


def _backend_module():
    return sys.modules.get(_BACKEND_MOD)

LATENCY_LABEL = "serve.submit_to_result"
BATCH_LABEL = "serve.batch_flush"
PREP_LABEL = "serve.prep_flush"


def _pow2(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class ServeMetrics:
    """Counters for one VerificationService instance.

    Occupancy is tracked on two axes, both of which cost real device time
    when wasted:
    - ROW occupancy: filled batch rows / padded rows (the backend rounds
      the batch axis up to a power of two);
    - LANE occupancy: actual committee keys / (rows * K bucket) (each item
      pads its key axis up to its bucket).

    ``node`` labels every exported metric (``serve[<node>].<name>``, the
    ``serve[`` dynamic family) so N service instances in one process
    publish side by side instead of overwriting shared gauges.
    """

    def __init__(self, node: Optional[str] = None):
        self.node = node
        self._latency_label = node_label(LATENCY_LABEL, node)
        self._batch_label = node_label(BATCH_LABEL, node)
        self._prep_label = node_label(PREP_LABEL, node)
        self._queue_depth_label = node_label("serve.queue_depth", node)
        self._hit_rate_label = node_label("serve.cache_hit_rate", node)
        self._occ_rows_label = node_label("serve.occupancy_rows", node)
        self._occ_lanes_label = node_label("serve.occupancy_lanes", node)
        self._mesh_devices_label = node_label("serve.mesh_devices", node)
        self._mesh_fallbacks_label = node_label("serve.mesh_fallbacks", node)
        self._ladder_rung_label = node_label("serve.ladder_rung", node)
        self._deadline_flushes_label = node_label("serve.deadline_flushes",
                                                  node)
        self._deadline_budget_label = node_label("serve.deadline_budget_ms",
                                                 node)
        self._lock = threading.Lock()
        self.submits = 0
        self.eager = 0  # resolved at submit time by the reference's own rules
        self.cache_hits = 0
        self.inflight_joins = 0
        self.enqueued = 0
        self.batches = 0
        self.rows_filled = 0
        self.rows_padded = 0
        self.lanes_filled = 0
        self.lanes_padded = 0
        self.backend_retries = 0
        self.fallback_batches = 0
        self.fallback_items = 0
        self.queue_depth_peak = 0
        # mesh plane: devices the service's verify mesh spans (0 =
        # single-device, the only path the port has) and how many sharded
        # attempts fell back to the single-device path (ladder rung 0)
        self.mesh_devices = 0
        self.mesh_fallbacks = 0
        # commanded degradation-ladder rung (load shedding)
        self.ladder_rung = 0
        # deadline-aware flush scheduling: flushes fired by
        # the slot-budget rule instead of size-or-deadline, and the slot
        # budget remaining (post-downstream-p99) at the latest one
        self.deadline_flushes = 0
        self.last_deadline_budget_ms = 0.0
        # prep-vs-device time split (the two pipeline stages): where a
        # flush's wall time goes, input-codec prep or the device stage. device_flushes counts whole flushes (like prep_batches)
        # so the two per-flush means share a denominator shape; `batches`
        # above counts (kind, K-bucket) GROUPS, of which a flush has >= 1
        self.prep_batches = 0
        self.prep_s = 0.0
        self.device_flushes = 0
        self.device_s = 0.0
        # RLC amortization baseline: the backend's combine/bisection/
        # final-exp counters are process-global, so snapshot() reports
        # THIS service's deltas. Backend not imported yet == counters at
        # zero, so the empty baseline is exact.
        mod = _backend_module()
        self._rlc_base = dict(mod.RLC_STATS) if mod is not None else {}

    # -- recording hooks (service.py) --------------------------------------

    def note_submit(self) -> None:
        with self._lock:
            self.submits += 1

    def note_eager(self) -> None:
        with self._lock:
            self.eager += 1

    def note_cache_hit(self) -> None:
        with self._lock:
            self.cache_hits += 1

    def note_inflight_join(self) -> None:
        with self._lock:
            self.inflight_joins += 1

    def note_enqueued(self, queue_depth: int) -> None:
        with self._lock:
            self.enqueued += 1
            self.queue_depth_peak = max(self.queue_depth_peak, queue_depth)
        profiling.set_gauge(self._queue_depth_label, queue_depth)

    def note_prep(self, seconds: float) -> None:
        with self._lock:
            self.prep_batches += 1
            self.prep_s += seconds
        profiling.record(self._prep_label, seconds)

    def note_batch(self, n_items: int, sum_k: int, bucket: int,
                   seconds: float) -> None:
        rows = _pow2(max(1, n_items))
        with self._lock:
            self.batches += 1
            self.rows_filled += n_items
            self.rows_padded += rows
            self.lanes_filled += sum_k
            self.lanes_padded += rows * bucket
        profiling.record(self._batch_label, seconds)

    def note_device_flush(self, seconds: float) -> None:
        with self._lock:
            self.device_flushes += 1
            self.device_s += seconds

    def note_retry(self) -> None:
        with self._lock:
            self.backend_retries += 1

    def note_mesh(self, n_devices: int) -> None:
        """Record the verify mesh's device count at service construction."""
        with self._lock:
            self.mesh_devices = n_devices
        profiling.set_gauge(self._mesh_devices_label, n_devices)

    def note_ladder(self, rung: int) -> None:
        """Record the commanded degradation-ladder rung (shed control)."""
        with self._lock:
            self.ladder_rung = rung
        profiling.set_gauge(self._ladder_rung_label, rung)

    def note_deadline_flush(self, budget_ms: float) -> None:
        """One flush fired early by the slot-budget rule; ``budget_ms``
        is the slot time that remained after subtracting the observed
        downstream p99 (how close the deadline actually was)."""
        with self._lock:
            self.deadline_flushes += 1
            self.last_deadline_budget_ms = budget_ms
            count = self.deadline_flushes
        profiling.set_gauge(self._deadline_flushes_label, count)
        profiling.set_gauge(self._deadline_budget_label, round(budget_ms, 3))

    def note_mesh_fallback(self) -> None:
        with self._lock:
            self.mesh_fallbacks += 1
            count = self.mesh_fallbacks
        profiling.set_gauge(self._mesh_fallbacks_label, count)

    def note_fallback(self, n_items: int) -> None:
        with self._lock:
            self.fallback_batches += 1
            self.fallback_items += n_items

    def note_result(self, latency_s: float) -> None:
        profiling.record_latency(self._latency_label, latency_s)

    # -- derived views ------------------------------------------------------

    @property
    def hit_rate(self) -> float:
        """Share of non-eager submits answered without new backend work
        (completed-result cache hits + in-flight dedup joins)."""
        served = self.submits - self.eager
        return (self.cache_hits + self.inflight_joins) / served if served else 0.0

    @property
    def row_occupancy(self) -> float:
        return self.rows_filled / self.rows_padded if self.rows_padded else 0.0

    @property
    def lane_occupancy(self) -> float:
        return self.lanes_filled / self.lanes_padded if self.lanes_padded else 0.0

    def export_gauges(self) -> None:
        """Publish the derived ratios into profiling.summary()."""
        profiling.set_gauge(self._hit_rate_label, self.hit_rate)
        profiling.set_gauge(self._occ_rows_label, self.row_occupancy)
        profiling.set_gauge(self._occ_lanes_label, self.lane_occupancy)

    def snapshot(self) -> Dict[str, float]:
        self.export_gauges()
        lat = profiling.latency_summary().get(self._latency_label, {})
        # backend prep-plane counters (codec batches and items, items left
        # to serial per-item prep): process-global like the caches they
        # describe
        bls_backend = _backend_module()
        prep_stats, rlc_stats = {}, {}
        if bls_backend is not None:
            prep_stats = dict(bls_backend.PREP_STATS)
            # a counter BELOW its baseline means bls_backend.reset_rlc_stats()
            # rewound the process-global ledger after this service was
            # constructed: the delta since that reset is then exactly the
            # current value (never negative, never hiding real activity)
            rlc_stats = {
                k: (cur if cur < self._rlc_base.get(k, 0)
                    else cur - self._rlc_base.get(k, 0))
                for k, cur in bls_backend.RLC_STATS.items()
            }
        with self._lock:
            prep_ms = (
                1e3 * self.prep_s / self.prep_batches
                if self.prep_batches else 0.0
            )
            device_ms = (
                1e3 * self.device_s / self.device_flushes
                if self.device_flushes else 0.0
            )
            # final exponentiations per SERVED request (non-eager submits:
            # everything the crypto plane answered, cache hits included;
            # the RLC combine and the dedup layer both amortize, and this
            # is the number that shows it)
            served = self.submits - self.eager
            final_exps_per_item = (
                rlc_stats.get("final_exps", 0) / served if served > 0 else 0.0
            )
            return {
                "submits": self.submits,
                "eager": self.eager,
                "enqueued": self.enqueued,
                "cache_hits": self.cache_hits,
                "inflight_joins": self.inflight_joins,
                "cache_hit_rate": round(self.hit_rate, 4),
                "batches": self.batches,
                "occupancy_rows": round(self.row_occupancy, 4),
                "occupancy_lanes": round(self.lane_occupancy, 4),
                "backend_retries": self.backend_retries,
                "fallback_batches": self.fallback_batches,
                "fallback_items": self.fallback_items,
                "mesh_devices": self.mesh_devices,
                "mesh_fallbacks": self.mesh_fallbacks,
                "ladder_rung": self.ladder_rung,
                "deadline_flushes": self.deadline_flushes,
                "last_deadline_budget_ms": round(
                    self.last_deadline_budget_ms, 3),
                "queue_depth_peak": self.queue_depth_peak,
                "prep_batches": self.prep_batches,
                "device_flushes": self.device_flushes,
                "prep_ms_per_flush": round(prep_ms, 3),
                "prep_ms_total": round(1e3 * self.prep_s, 3),
                "device_ms_per_flush": round(device_ms, 3),
                "device_ms_total": round(1e3 * self.device_s, 3),
                "prep": prep_stats,
                "rlc": rlc_stats,
                "final_exps_per_item": round(final_exps_per_item, 4),
                # rows the last device finalization window coalesced (0 =
                # host route or no device finalization yet this process),
                # read via stats_and_gauges: one lock-protected dict copy
                "final_exp_rows_inflight": int(
                    profiling.stats_and_gauges()[1]
                    .get("bls.final_exp_rows_inflight", 0)
                ),
                "latency": lat,
            }
