"""Committee-affinity fleet routing for the mainnet workload (the port's
copy of consensus_specs_tpu/scale/routing.py, the same keys).

The fleet router's default key is CONTENT (``serve/cache.check_key``):
right for result-cache affinity, useless for *state* affinity: every slot
a committee's aggregate has a fresh message and signature, so its
sub-batches would scatter across workers and every worker would end up
decompressing the whole registry. This plane routes by COMMITTEE INDEX
instead: the consistent-hash ring maps ``committee_key(index)`` to a
worker label, so a committee's pubkey working set (the expensive,
slot-invariant part) stays warm on exactly one worker across slots, and
ring churn (a drained or respawned worker) moves only the committees
whose arc moved, counted as ``scale.affinity_moves``.
"""
import hashlib
from typing import Dict, List, Optional, Sequence

COMMITTEE_KEY_TAG = b"scale-committee-affinity:"


def committee_key(index: int) -> bytes:
    """Stable routing key for a committee index (slot-invariant: the
    point of affinity is that slots don't move state)."""
    return hashlib.sha256(
        COMMITTEE_KEY_TAG + int(index).to_bytes(8, "little")).digest()


class CommitteeFleet:
    """FleetRouter facade that routes committee sub-batches by
    committee-index affinity instead of content keys.

    ``submit_committee`` bypasses ``FleetRouter.submit``'s content-key
    routing and hands the item straight to the affine worker's handle
    (the same WorkerHandle path the router itself uses), so the
    worker-side result cache and host pubkey caches see every slot of
    the same committee. ``router_kwargs`` go to the ``FleetRouter``
    (``device=`` among them: None is the card)."""

    def __init__(self, workers: int = 2, *, backend: str = "verdict",
                 env: Optional[Dict[str, str]] = None, router=None,
                 **router_kwargs):
        if router is None:
            from ..serve.fleet import FleetRouter

            router = FleetRouter(workers=workers, backend=backend,
                                 env=env, **router_kwargs)
            self._owns_router = True
        else:
            self._owns_router = False
        self.router = router
        self._last_label: Dict[int, str] = {}
        self.committees_routed = 0
        self.affinity_moves = 0

    # -- routing -------------------------------------------------------------

    def label_for(self, committee_index: int) -> str:
        return self.router.route_label(committee_key(committee_index))

    def assignment(self, committee_indices: Sequence[int]
                   ) -> Dict[int, str]:
        """Current committee -> worker-label map (pure ring lookup)."""
        return {int(ci): self.label_for(int(ci))
                for ci in committee_indices}

    def submit_committee(self, committee_index: int, kind: str,
                         pubkeys, messages, signature,
                         birth_s: Optional[float] = None,
                         flow_id: Optional[int] = None):
        """Route one committee sub-batch to its affine worker."""
        label = self.label_for(committee_index)
        prev = self._last_label.get(committee_index)
        if prev is not None and prev != label:
            self.affinity_moves += 1
        if prev is None:
            self.committees_routed += 1
        self._last_label[committee_index] = label
        self._export_gauges()
        with self.router._lock:
            self.router.requests += 1
        return self.router.handle(label).submit(
            kind, pubkeys, messages, signature,
            birth_s=birth_s, flow_id=flow_id)

    def submit_slot(self, items, timeout: float = 600.0) -> List[bool]:
        """Submit a slot's committee items (index = committee index)
        and gather ordered verdicts."""
        futs = [self.submit_committee(ci, *item)
                for ci, item in enumerate(items)]
        return [bool(f.result(timeout=timeout)) for f in futs]

    def _export_gauges(self) -> None:
        from ..ops import profiling

        profiling.set_gauge("scale.committees_routed",
                            float(self.committees_routed))
        profiling.set_gauge("scale.affinity_moves",
                            float(self.affinity_moves))

    # -- lifecycle -----------------------------------------------------------

    def close(self, timeout: float = 60.0) -> None:
        if self._owns_router:
            self.router.close(timeout=timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
