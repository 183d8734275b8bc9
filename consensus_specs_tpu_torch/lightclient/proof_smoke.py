"""Light-client proof-plane canary of the port (the counterpart of
consensus_specs_tpu/lightclient/proof_smoke.py; the fleet smoke's read-path
sibling):

    python -m consensus_specs_tpu_torch.lightclient.proof_smoke

One full proof round trip against a REAL 2-worker fleet
(``serve/worker.py`` processes, the port's bls backend on the card unless
``device="cpu"``):

1. **Serve**: a ``ProofService`` builds the per-slot artifact — finality
   branch, next-sync-committee branch, combined multiproof, and the
   assembled ``LightClientUpdate`` — and routes the update's
   sync-committee signature through the fleet router. The fleet verdict
   must land ``artifact.verified is True`` before the artifact is
   published; a second fetch of the same ``(slot, state_root)`` key must
   be a cache hit returning the identical object. Then each worker is
   handed the update's check itself and must answer True, and every
   worker must report the router's device; on the card, its name and at
   least one launch of each kernel
   (``serve/fleet_smoke.check_worker_devices``).

2. **Verify**: the served bytes are checked the way a client would — the
   spec's ``validate_light_client_update`` (both Merkle branches, period
   math, and the sync-committee ``FastAggregateVerify``, through the
   port's switchboard) plus every branch re-hashed via
   ``is_valid_merkle_branch`` against an INDEPENDENTLY re-Merkleized state
   root (fresh ``decode_bytes`` round trip — no warm-cache reuse on the
   verify side). A negative control flips one branch byte and must fail.

The journal — merged fleet events plus the host's ``lightclient``-plane
build/verify notes — always dumps to ``proof_flight.jsonl``. Exit 0 on
pass, 1 with a diagnosis otherwise.
"""
import contextlib
import os
import sys

WORKERS = 2
JOURNAL_PATH = "proof_flight.jsonl"


@contextlib.contextmanager
def _switchboard_on(device):
    """The spec's own checks (through the port's switchboard) on the
    fleet's device: the card by default, the pure-Python oracle for a CPU
    fleet; the switchboard's backend is restored after."""
    from ..utils import bls

    was = bls._backend
    if device.type == "cpu":
        bls.use_py_ecc()
    try:
        yield
    finally:
        bls._backend = was


def main(device=None, report=None) -> int:
    """The round trip on ``device`` (None: the card). When ``report`` is a
    dict it receives each worker's last snapshot (``snapshots``) and the
    pass record (``result``)."""
    os.environ["CONSENSUS_SPECS_TPU_FLIGHT"] = "1"
    os.environ.setdefault("CONSENSUS_SPECS_TPU_FLIGHT_DUMP", JOURNAL_PATH)

    from ..builder import build_spec_module
    from ..obs import flight
    from ..obs.slo import ShedPolicy
    from ..serve.fleet import FleetRouter
    from ..serve.fleet_smoke import check_worker_devices
    from .proof_tree import (
        ProofWorld, build_update_artifact, floorlog2, subtree_index,
        verify_artifact,
    )
    from .serve_proofs import ProofService

    router = None
    host = flight.maybe_recorder()
    try:
        spec = build_spec_module("altair", "minimal")
        world = ProofWorld(spec)
        router = FleetRouter(
            workers=WORKERS, backend="bls", device=device,
            env={"SERVE_MAX_WAIT_MS": "300",
                 "CONSENSUS_SPECS_TPU_FLIGHT": "1"},
            policy=ShedPolicy(),
        )
        # the router IS the verifier: same submit() contract as a
        # single-process VerificationService, real process boundary
        service = ProofService(verifier=router)

        head_slot = world.finalized_slot + 1
        state = world.head_state(head_slot)
        state_root = bytes(state.hash_tree_root())

        def build():
            return build_update_artifact(
                spec, state, world.finalized_state,
                genesis_validators_root=world.genesis_validators_root,
                sign=world.sign)

        # -- phase 1: serve through the fleet ---------------------------------
        artifact = service.serve(head_slot, state_root, build)
        assert artifact.verified is True, (
            "the fleet's sync-committee signature verdict did not land "
            f"True on the artifact: {artifact.verified!r}")
        again = service.serve(head_slot, state_root, build)
        assert again is artifact, (
            "second fetch of the same content address rebuilt instead of "
            "hitting the cache")
        snap = service.snapshot()
        assert snap["builds"] == 1 and snap["cache_hits"] == 1, (
            f"cache accounting wrong for build-then-hit: {snap}")
        # every worker, not only the one the router picked, answers the
        # update's sync-committee check True: the whole fleet verifies
        check = ("fast_aggregate",
                 [bytes(pk) for pk in artifact.participant_pubkeys],
                 bytes(artifact.signing_root),
                 bytes(artifact.update.sync_committee_signature))
        per_worker = {
            label: bool(router.handle(label).submit(*check).result(
                timeout=600))
            for label in router.live_workers}
        assert len(per_worker) == WORKERS and all(per_worker.values()), (
            f"a worker's verdict on the served update: {per_worker}")

        # -- phase 2: client-side verification, cold root ---------------------
        fresh = spec.BeaconState.decode_bytes(state.encode_bytes())
        fresh_root = bytes(fresh.hash_tree_root())
        assert fresh_root == state_root, (
            "re-Merkleized root drifted from the served state root")
        with _switchboard_on(router.device):
            verify_artifact(spec, artifact, world.snapshot,
                            world.genesis_validators_root,
                            state_root=fresh_root)

        # negative control: one flipped byte in the finality branch must
        # fail the client-side Merkle check
        g = artifact.finality_gindex
        bad = [bytes(b) for b in artifact.finality_branch]
        bad[0] = bytes([bad[0][0] ^ 1]) + bad[0][1:]
        assert not spec.is_valid_merkle_branch(
            spec.Root(artifact.finalized_root),
            [spec.Bytes32(b) for b in bad],
            floorlog2(g), subtree_index(g), spec.Root(fresh_root)), (
            "a corrupted finality branch still verified")

        # -- the workers ran on the router's device --------------------------
        snaps = router.poll_snapshots()
        assert len(snaps) == WORKERS, f"snapshots from {sorted(snaps)}"
        check_worker_devices(snaps, router.device)
        if report is not None:
            report["snapshots"] = snaps

        # -- journal reconstruction -------------------------------------------
        fleet_journal = router.journal_jsonl(reason="proof_smoke")
        host_events = host.events() if host is not None else []
        builds = [e for e in host_events
                  if e.get("plane") == "lightclient"
                  and e.get("kind") == "proof_build"]
        assert builds, (
            "the proof build missing from the host lightclient journal")
        with open(JOURNAL_PATH, "w") as fh:
            fh.write(fleet_journal)
            if host is not None:
                fh.write(host.to_jsonl(reason="proof_smoke"))
        n_events = len(fleet_journal.splitlines()) - 1 + len(host_events)
        if report is not None:
            report["result"] = {
                "workers": WORKERS, "device": router.device.type,
                "slot": head_slot, "seats": len(world.sks),
                "builds": snap["builds"], "cache_hits": snap["cache_hits"],
                "journal": JOURNAL_PATH, "journal_events": n_events}
        print(
            f"proof-smoke OK: {WORKERS} workers on {router.device.type}, "
            f"artifact verified by the "
            f"fleet AND validate_light_client_update + is_valid_merkle_"
            f"branch against a re-Merkleized root, cache "
            f"{snap['builds']} build / {snap['cache_hits']} hit, corrupted "
            f"branch rejected, journal {JOURNAL_PATH} ({n_events} events)"
        )
        return 0
    except Exception as e:
        print(f"proof-smoke FAIL: {type(e).__name__}: {e}")
        try:
            with open(JOURNAL_PATH, "w") as fh:
                if router is not None:
                    fh.write(router.journal_jsonl(reason="proof_smoke_fail"))
                if host is not None:
                    fh.write(host.to_jsonl(reason="proof_smoke_fail"))
            print(f"proof-smoke: journal dumped to {JOURNAL_PATH}")
        except Exception:
            pass
        return 1
    finally:
        if router is not None:
            router.close()


if __name__ == "__main__":
    sys.exit(main())
