"""SimNode: one full consensus participant inside the simulated network
(the port's copy of consensus_specs_tpu/sim/node.py).

Each node owns the REAL production stack, not a mock of it:

- its own spec ``Store`` + incremental proto-array behind the port's
  ``chain.HeadService`` (so every delivered attestation runs the spec
  validation pipeline and every delivered block feeds fork choice
  exactly as live gossip would);
- its own port ``serve.service.VerificationService`` on the node's
  device over the crypto-free ``VerdictBackend`` (batching, dedup,
  caching and False-verdict routing all exercised; the verdict rides in
  the signature bytes so synthetic votes skip the pairings, and no kernel
  is launched);
- its own node-labelled observability: ``chain[<name>].*`` /
  ``serve[<name>].*`` metric families and a per-node
  ``obs.flight.FlightRecorder`` journaling on the SIMULATED clock — the
  per-node black boxes the scenario runs dump on failure.

The node's clock only moves forward, driven by the runner as events
reach it (``advance_clock``); a partitioned node that hears nothing
simply stays behind until the heal-time sync fast-forwards it, exactly
like a real client rejoining.
"""
from typing import Optional, Set

from ..chain import HeadService
from ..chain.metrics import ChainMetrics
from ..lightclient.proof_tree import build_head_proof, verify_head_proof
from ..lightclient.serve_proofs import ProofService
from ..obs import latency
from ..obs.flight import FlightRecorder
from ..serve.load import VerdictBackend
from ..serve.service import VerificationService
from .fabric import Message

__all__ = ["SimNode", "LightClientNode"]


class SimNode:
    """One simulated consensus node (index ``i``, name ``n<i>``).

    ``service_kwargs`` / ``head_kwargs`` override the node's
    VerificationService / HeadService construction knobs — the latency
    smoke uses them to arm the slot-budget flush scheduler
    (``slot_clock=``) and speculative head application
    (``speculative=True``) without touching the scenario scripts.
    ``device`` is the node service's device (None: the CUDA card)."""

    def __init__(self, index: int, spec, anchor_state, anchor_block,
                 shared_state, *, honest: bool = True, sim_clock=None,
                 flight_capacity: int = 4096, backend=None,
                 service_kwargs: Optional[dict] = None,
                 head_kwargs: Optional[dict] = None, device=None):
        self.index = index
        self.name = f"n{index}"
        self.honest = honest
        self.spec = spec
        self._shared_state = shared_state
        self._seconds_per_slot = int(spec.config.SECONDS_PER_SLOT)
        self.recorder = FlightRecorder(
            capacity=flight_capacity, node=self.name,
            clock=sim_clock if sim_clock is not None else (lambda: 0.0))
        # default: the in-process crypto-free VerdictBackend; the fleet
        # replay (sim/fleet_replay.py) injects an adapter that routes
        # every check to REAL worker processes instead — same verdict
        # rule, real process boundary
        self.backend = backend if backend is not None else VerdictBackend()
        svc_kwargs = dict(max_batch=8, max_wait_ms=1.0, device=device)
        svc_kwargs.update(service_kwargs or {})
        self.service = VerificationService(
            backend=self.backend, node=self.name, **svc_kwargs)
        hd_kwargs = dict(differential=False)
        hd_kwargs.update(head_kwargs or {})
        self.head = HeadService(
            spec, anchor_state, anchor_block, service=self.service,
            metrics=ChainMetrics(node=self.name), node=self.name,
            recorder=self.recorder, **hd_kwargs)
        self._genesis_time = int(anchor_state.genesis_time)
        self._clock_slot = 0
        self._seen: Set[str] = set()
        self.known: list = []  # receipt-ordered Messages (the sync source)
        self.duplicates = 0
        # orphan BLOCK buffer (the attestation deferral buffer's sibling):
        # gossip can deliver a child before its parent, and the proto
        # array requires parents first — park the child, import it the
        # moment its parent lands (real clients hold an identical queue)
        self._orphan_blocks = {}  # parent root bytes -> [block, ...]
        self.orphaned_blocks = 0
        # the light-client proof plane: lazy — a node pays for
        # a ProofService only once a client actually fetches from it
        self._proofs: Optional[ProofService] = None
        self._state_root: Optional[bytes] = None

    # -- clock ---------------------------------------------------------------

    def advance_clock(self, sim_t: float) -> None:
        """Move the node's store clock to the slot containing ``sim_t``
        (simulation seconds since genesis). Monotone: late events never
        rewind it. ``on_tick`` retries time-gated deferred gossip."""
        slot = int(sim_t // self._seconds_per_slot)
        if slot > self._clock_slot:
            self._clock_slot = slot
            self.head.on_tick(
                self._genesis_time + slot * self._seconds_per_slot)

    # -- gossip ingress ------------------------------------------------------

    def receive(self, msg: Message) -> bool:
        """Deliver one message; returns True on FIRST receipt (the caller
        re-broadcasts then — flood gossip's dedup rule)."""
        if msg.mid in self._seen:
            self.duplicates += 1
            return False
        self._seen.add(msg.mid)
        self.known.append(msg)
        if msg.kind == "block":
            block = msg.payload
            if block.parent_root not in self.head.store.blocks:
                self.orphaned_blocks += 1
                self._orphan_blocks.setdefault(
                    bytes(block.parent_root), []).append(block)
            else:
                self._import_block(block)
        else:
            # the gossip→head timeline's origin: the attestation is born
            # (obs/latency.py) the wall-clock moment the fabric delivers
            # it to THIS node — what lands in latency.gossip_to_head is
            # the real processing+flush latency through the node's full
            # serve/chain stack, deferral churn included
            self.head.on_attestations([msg.payload],
                                      births=[latency.birth()])
        return True

    def _import_block(self, block) -> None:
        """Crafted-state ingress (the head-replay contract): register the
        block, retry exactly the deferred gossip it resolves, then drain
        any parked children it just re-parented."""
        self.head.import_block_unchecked(
            block, state=self._shared_state, resolve=True)
        root = bytes(self.spec.hash_tree_root(block))
        for child in self._orphan_blocks.pop(root, ()):
            self._import_block(child)

    def knows(self, mid: str) -> bool:
        return mid in self._seen

    # -- reading -------------------------------------------------------------

    def get_head(self) -> bytes:
        return bytes(self.head.get_head())

    # -- light-client proof serving ------------------------------------------

    @property
    def proofs(self) -> ProofService:
        if self._proofs is None:
            self._proofs = ProofService(
                node=self.name, recorder=self.recorder)
        return self._proofs

    def serve_head_proof(self) -> dict:
        """One light-client response: the node's current head (root +
        block) plus the content-addressed proof artifact for it. Sim
        blocks carry crafted state roots and every block maps to the one
        shared anchor state, so the artifact's finality branch is built
        over (and verified against) that state — the weak-subjectivity
        checkpoint every sim light client trusts. Keyed by
        ``(head_slot, state_root)``: repeated fetches at one head slot
        are cache hits, exactly the production content-address rule."""
        head_root = self.get_head()
        block = self.head.store.blocks[self.spec.Root(head_root)]
        head_slot = int(block.slot)
        if self._state_root is None:
            self._state_root = bytes(self._shared_state.hash_tree_root())
        artifact = self.proofs.serve(
            head_slot, self._state_root,
            lambda: build_head_proof(self.spec, self._shared_state))
        return {"node": self.name, "head_root": head_root,
                "head_slot": head_slot, "block": block,
                "artifact": artifact}

    def snapshot(self) -> dict:
        snap = self.head.metrics.snapshot()
        return {
            "applied": snap["applied"],
            "deferred": snap["deferred"],
            "resolved": snap["resolved"],
            "dropped": snap["dropped"],
            "blocks": snap["blocks"],
            "head_changes": snap["head_changes"],
            "reorgs": snap["reorgs"],
            "head_slot": snap["head_slot"],
            "deferred_pending": snap["deferred_pending"],
            "speculative_applied": snap["speculative_applied"],
            "rollbacks": snap["rollbacks"],
            "deadline_flushes": self.service.metrics.deadline_flushes,
            "duplicates": self.duplicates,
            "backend_calls": self.backend.calls,
            "proofs": (self._proofs.snapshot()
                       if self._proofs is not None else None),
        }

    def close(self) -> None:
        self.service.close(timeout=30)


class LightClientNode:
    """The simnet ``light_client`` node kind (index ``i``, name ``c<i>``):
    a read-only participant that never gossips or votes — it fetches head
    proofs from full nodes and verifies every byte against its own
    trusted weak-subjectivity checkpoint (the anchor state root), the sim
    mirror of a ``validate_light_client_update`` store:

    - the served state root must BE the trusted root (the client accepts
      no other state commitment),
    - the finality branch must re-hash to it (real SHA-256 through
      ``spec.is_valid_merkle_branch`` — no served intermediate reuse),
    - the served head root must equal ``hash_tree_root`` of the served
      block (re-hashed locally), and
    - accepted heads advance monotonically (the mirror of
      ``validate_light_client_update``'s slot assertion; a stale proof
      from a lagging node is rejected, not an error).

    Any cryptographic mismatch is a ``failure`` — the convergence gate
    fails the scenario on a single one.
    """

    def __init__(self, index: int, spec, anchor_state, *, sim_clock=None,
                 flight_capacity: int = 1024):
        self.index = index
        self.name = f"c{index}"
        self.spec = spec
        self.trusted_state_root = bytes(anchor_state.hash_tree_root())
        self.recorder = FlightRecorder(
            capacity=flight_capacity, node=self.name,
            clock=sim_clock if sim_clock is not None else (lambda: 0.0))
        self.head_root = b""
        self.head_slot = -1
        self.last_server = ""
        self.fetches = 0
        self.verified = 0
        self.failures = 0
        self.rejected_stale = 0

    def fetch(self, server: SimNode) -> bool:
        """Fetch + verify one head proof from ``server``; True when the
        proof verified AND advanced (or re-confirmed) the client's head."""
        self.fetches += 1
        resp = server.serve_head_proof()
        try:
            verify_head_proof(self.spec, resp["artifact"],
                              self.trusted_state_root)
            served_root = bytes(resp["head_root"])
            assert bytes(self.spec.hash_tree_root(resp["block"])) == \
                served_root, "served head root does not re-hash to block"
            assert int(resp["block"].slot) == int(resp["head_slot"]), \
                "served head slot does not match block"
        except AssertionError as exc:
            self.failures += 1
            self.recorder.note("lightclient", "proof_reject",
                               server=server.name, error=str(exc))
            return False
        if int(resp["head_slot"]) < self.head_slot:
            self.rejected_stale += 1
            self.recorder.note("lightclient", "proof_stale",
                               server=server.name,
                               slot=int(resp["head_slot"]),
                               have=self.head_slot)
            return False
        self.verified += 1
        self.head_root = served_root
        self.head_slot = int(resp["head_slot"])
        self.last_server = server.name
        self.recorder.note("lightclient", "proof_accept",
                           server=server.name, slot=self.head_slot)
        return True

    def snapshot(self) -> dict:
        return {
            "fetches": self.fetches,
            "verified": self.verified,
            "failures": self.failures,
            "rejected_stale": self.rejected_stale,
            "head_slot": self.head_slot,
            "head": self.head_root.hex()[:16],
            "last_server": self.last_server,
        }
