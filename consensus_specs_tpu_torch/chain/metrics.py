"""Chain-plane observability (the port's copy of
consensus_specs_tpu/chain/metrics.py): head movement, reorg shape,
attestation routing outcomes, and apply-batch latency.

Counters live on the owning :class:`HeadService`; the derived values
export through ``ops/profiling`` (the ``chain.*`` family in
``obs/registry.py``) so ``/metrics`` scrapes and bench JSON lines carry
the chain numbers the same way they carry the serve plane's.

Multi-instance runs (the ``sim/`` plane drives N ``HeadService``
instances in one process) pass ``node=``: every label then exports in
the node-labelled form ``chain[<node>].<name>`` (the ``chain[`` dynamic
family in ``obs/registry.py``) instead of the bare ``chain.*`` name, so
N instances publish side by side instead of overwriting one shared
gauge.
"""
import threading
from typing import Dict, Optional

from ..obs.registry import node_label
from ..ops import profiling

APPLY_LABEL = "chain.apply_batch"

# the gauge family, in export order (the obs drift gate scans this tuple:
# every name must be registered in obs/registry.py and documented in the
# README metric table)
GAUGE_LABELS = (
    "chain.blocks",
    "chain.head_slot",
    "chain.head_changes",
    "chain.reorgs",
    "chain.last_reorg_depth",
    "chain.applied_attestations",
    "chain.deferred_attestations",
    "chain.dropped_attestations",
    "chain.deferred_pending",
    "chain.speculative_applied",
    "chain.rollbacks",
)


class ChainMetrics:
    """Counters for one HeadService instance. ``node`` labels every
    exported metric for multi-instance (simnet) processes."""

    def __init__(self, node: Optional[str] = None):
        self.node = node
        self._apply_label = node_label(APPLY_LABEL, node)
        self._gauge_labels = tuple(
            node_label(label, node) for label in GAUGE_LABELS)
        self._lock = threading.Lock()
        self.blocks = 0
        self.batches = 0
        self.applied = 0       # attestations that updated a latest message
        self.stale = 0         # verified but older than the known vote
        self.deferred = 0      # parked for a missing block / future slot
        self.dropped = 0       # invalid signature / non-viable / overflow
        self.resolved = 0      # deferred entries that later applied
        self.head_changes = 0
        self.reorgs = 0        # head changes that were not simple extensions
        self.last_reorg_depth = 0
        self.head_slot = 0
        self.deferred_pending = 0
        self.pruned_nodes = 0
        # speculative head application: attestations applied
        # to the proto-array before their verdicts returned, and batches
        # that had to be reverted (weight-delta reversal) on a failure
        self.speculative_applied = 0
        self.rollbacks = 0

    # -- recording hooks (head_service.py) ----------------------------------

    def note_block(self) -> None:
        with self._lock:
            self.blocks += 1

    def note_applied(self, n: int = 1) -> None:
        with self._lock:
            self.applied += n

    def note_stale(self, n: int = 1) -> None:
        with self._lock:
            self.stale += n

    def note_deferred(self, pending: int) -> None:
        with self._lock:
            self.deferred += 1
            self.deferred_pending = pending

    def note_resolved(self, pending: int, n: int = 1) -> None:
        with self._lock:
            self.resolved += n
            self.deferred_pending = pending

    def note_dropped(self, n: int = 1) -> None:
        with self._lock:
            self.dropped += n

    def note_pruned(self, n: int) -> None:
        with self._lock:
            self.pruned_nodes += n

    def note_speculative(self, n: int = 1) -> None:
        with self._lock:
            self.speculative_applied += n

    def note_rollback(self) -> None:
        with self._lock:
            self.rollbacks += 1

    def note_batch(self, seconds: float) -> None:
        with self._lock:
            self.batches += 1
        profiling.record_latency(self._apply_label, seconds)

    def note_head(self, slot: int, changed: bool, reorg_depth: int) -> None:
        with self._lock:
            self.head_slot = int(slot)
            if changed:
                self.head_changes += 1
            if reorg_depth > 0:
                self.reorgs += 1
                self.last_reorg_depth = reorg_depth

    # -- export --------------------------------------------------------------

    def export_gauges(self, tracked_blocks: int = None) -> None:
        """Publish the chain family into ``profiling.summary()`` (and so
        onto ``/metrics``). Values line up with ``GAUGE_LABELS``."""
        with self._lock:
            values = (
                self.blocks if tracked_blocks is None else tracked_blocks,
                self.head_slot,
                self.head_changes,
                self.reorgs,
                self.last_reorg_depth,
                self.applied,
                self.deferred,
                self.dropped,
                self.deferred_pending,
                self.speculative_applied,
                self.rollbacks,
            )
        for label, value in zip(self._gauge_labels, values):
            profiling.set_gauge(label, value)
        # the chain plane is the merkle plane's highest-rate consumer
        # (per-block state re-roots), so its export also refreshes the
        # process-wide merkle.* counters onto the same surface
        from ..merkle import levels as _merkle_levels

        _merkle_levels.export_gauges()

    def counters(self) -> Dict[str, int]:
        """Plain counter reads (no latency-summary build) — what the
        per-slot health ledger (``chain/health.py``) diffs every slot,
        where ``snapshot()``'s percentile construction would dominate
        the slot's own cost at soak horizons."""
        with self._lock:
            return {
                "blocks": self.blocks,
                "head_changes": self.head_changes,
                "reorgs": self.reorgs,
                "last_reorg_depth": self.last_reorg_depth,
                "head_slot": self.head_slot,
                "deferred_pending": self.deferred_pending,
                "speculative_applied": self.speculative_applied,
                "rollbacks": self.rollbacks,
            }

    def snapshot(self) -> Dict[str, float]:
        lat = profiling.latency_summary().get(self._apply_label, {})
        with self._lock:
            return {
                "blocks": self.blocks,
                "batches": self.batches,
                "applied": self.applied,
                "stale": self.stale,
                "deferred": self.deferred,
                "resolved": self.resolved,
                "dropped": self.dropped,
                "head_changes": self.head_changes,
                "reorgs": self.reorgs,
                "last_reorg_depth": self.last_reorg_depth,
                "head_slot": self.head_slot,
                "deferred_pending": self.deferred_pending,
                "pruned_nodes": self.pruned_nodes,
                "speculative_applied": self.speculative_applied,
                "rollbacks": self.rollbacks,
                "apply_latency": lat,
            }
