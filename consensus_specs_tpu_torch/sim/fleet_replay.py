"""Simnet scenario replayed against REAL fleet worker processes (the
port's copy of consensus_specs_tpu/sim/fleet_replay.py, over the port's
``FleetRouter``).

Every simnet scenario so far verified its gossip in-process: each
`SimNode` owns a `VerdictBackend` object one pointer away. The Beacon-
client security review (PAPERS.md) motivates replaying adversarial
traffic against the real deployment shape instead — so this module runs
a named scenario with every node's signature checks routed through the
fleet router (`serve/fleet.py`) to real `serve/worker.py` PROCESSES in
verdict mode: the same batching/dedup/caching pipeline, the same
BAD_SIGNATURE verdict rule, but the answer crosses a genuine process
boundary (pipes, serialization, a separate GIL) before fork choice sees
it. The differential convergence gate is unchanged — honest heads must
still land bit-identical to ``spec.get_head`` — which is exactly the
claim worth having: the fleet is transparent to consensus.

Content-key affinity makes the fleet fleet-correct here too: every node
hears the same aggregates, and the router sends identical content to the
same worker, whose cache answers repeats — N nodes' worth of duplicate
gossip costs the fleet one verification per distinct aggregate.
"""
from typing import Dict, Optional

from .runner import build_world, run_scenario
from .scenarios import get_scenario

__all__ = ["FleetVerdictBackend", "run_fleet_replay"]


class FleetVerdictBackend:
    """Node-side adapter: the `VerificationService` backend surface
    (``batch_*`` calls) routed through a shared `FleetRouter`. Carries
    the same ``calls``/``items`` ledger as `VerdictBackend`, so node
    snapshots keep reporting backend activity."""

    # cross-process flow stitching: the node-side
    # VerificationService hands this backend each item's Chrome flow id
    # (serve/service.py honors the declaration below), and the router
    # forwards it over the worker protocol — so the WORKER process's
    # request spans carry the same flow id the node-side serve/chain
    # traces emit, and the stitched fleet trace joins them across pids
    wants_flow_context = True

    def __init__(self, router, node: Optional[str] = None,
                 timeout: float = 120.0):
        self._router = router
        self._timeout = timeout
        self.node = node
        self.calls = 0
        self.items = 0

    def _route(self, kind, pubkey_sets, message_likes, signatures,
               flows=None):
        self.calls += 1
        self.items += len(signatures)
        if flows is None:
            flows = [None] * len(signatures)
        futures = [
            self._router.submit(kind, pks, msg, sig, flow_id=fid)
            for pks, msg, sig, fid in zip(pubkey_sets, message_likes,
                                          signatures, flows)
        ]
        return [bool(f.result(timeout=self._timeout)) for f in futures]

    def batch_fast_aggregate_verify(self, pubkey_sets, messages, signatures,
                                    flows=None, device=None):
        return self._route("fast_aggregate", pubkey_sets, messages,
                           signatures, flows=flows)

    def batch_aggregate_verify(self, pubkey_sets, message_sets, signatures,
                               flows=None, device=None):
        return self._route("aggregate", pubkey_sets, message_sets,
                           signatures, flows=flows)


def run_fleet_replay(scenario: str = "partition_heal", *, workers: int = 2,
                     nodes: Optional[int] = None, seed: int = 7,
                     strict: bool = True,
                     flight_dir: Optional[str] = None,
                     router=None, device=None) -> Dict:
    """Run one scenario with per-node fleet-routed verification.

    Returns ``{"report": ScenarioReport, "fleet": {...}}`` where the
    fleet dict proves the workers really did the verifying: per-worker
    submit counts from their final wire snapshots, the router's routed
    total, and the worker labels. ``router`` injects a pre-built router
    (tests reuse one fleet across cases); otherwise a verdict-mode fleet
    is spawned on ``device`` (None: the card) and closed here. The nodes'
    own services run on the router's device; the backend adapter takes
    the ``device`` the service passes and leaves it to the router."""
    from ..serve.fleet import FleetRouter

    own_router = router is None
    if router is None:
        router = FleetRouter(workers=workers, backend="verdict",
                             device=device, env={"SERVE_MAX_WAIT_MS": "2"})
    try:
        spec, anchor_state, anchor_block = build_world()
        report = run_scenario(
            get_scenario(scenario), spec=spec, anchor_state=anchor_state,
            anchor_block=anchor_block, seed=seed, nodes=nodes,
            strict=strict, flight_dir=flight_dir, device=router.device,
            backend_factory=lambda name: FleetVerdictBackend(router, name))
        snaps = router.poll_snapshots()
        per_worker = {
            label: {
                "submits": snap["extra"]["serve"]["submits"],
                "cache_hits": snap["extra"]["serve"]["cache_hits"],
                "batches": snap["extra"]["serve"]["batches"],
                "device": snap["extra"].get("device"),
                "device_name": snap["extra"].get("device_name"),
            }
            for label, snap in sorted(snaps.items())
        }
        return {
            "report": report,
            "fleet": {
                "workers": sorted(snaps),
                "routed": router.requests,
                "per_worker": per_worker,
            },
        }
    finally:
        if own_router:
            router.close()
