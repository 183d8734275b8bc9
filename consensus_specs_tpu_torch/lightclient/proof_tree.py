"""Per-slot light-client proof artifacts (the port's copy of
consensus_specs_tpu/lightclient/proof_tree.py, over the port's own spec,
SSZ and proofs).

One artifact is materialized per ``(slot, state_root)`` from the head
state (plus the finalized state it commits to) and then served to every
client at that slot — the content address makes the cache hit rate
approach 1 at steady state. The artifact carries the two sync-protocol
commitments as separate branches (reference
specs/altair/sync-protocol.md:67-85) AND as one combined multiproof over
the head state, plus a fully assembled ``LightClientUpdate`` ready for
``validate_light_client_update``.

Header roles follow ``specsrc/altair/sync_protocol.py`` exactly:
``update.header`` is the FINALIZED header (its state root authenticates
``next_sync_committee`` at gindex 55), ``update.finality_header`` is the
attested/signed head header (its state root authenticates the finalized
header's root at gindex 105, and it is what the sync committee signed).

``build_head_proof``/``verify_head_proof`` are the phase0 shape the
simnet serves: the finalized-root branch only (phase0 states carry no
sync committees), verified by real SHA-256 re-hashing on the client.
phase0's ``BeaconState`` puts ``finalized_checkpoint.root`` at the same
generalized index 105 as altair's (both field counts round up to a
32-wide root layer), so the simnet exercises the identical tree position.
"""
import hashlib
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Sequence, Tuple

from ..utils.ssz.gindex import get_generalized_index
from ..utils.ssz.proofs import (
    build_proof,
    build_proof_bundle,
    verify_merkle_multiproof,
)

# sync-protocol constants (reference specs/altair/sync-protocol.md;
# asserted against the live state types in build_update_artifact)
FINALIZED_ROOT_GINDEX = 105
NEXT_SYNC_COMMITTEE_GINDEX = 55


def floorlog2(gindex: int) -> int:
    return int(gindex).bit_length() - 1


def subtree_index(gindex: int) -> int:
    # spec get_subtree_index: position within the proven subtree layer
    return int(gindex) % (1 << floorlog2(gindex))


def proof_key(slot: int, state_root: bytes) -> bytes:
    """Content address of one slot's artifact (mirror of
    ``serve/cache.py``'s length-framed sha256 keying)."""
    h = hashlib.sha256()
    h.update(b"proof:")
    h.update(int(slot).to_bytes(8, "little"))
    root = bytes(state_root)
    h.update(len(root).to_bytes(4, "little"))
    h.update(root)
    return h.digest()


@dataclass
class ProofArtifact:
    """Everything a light client needs for one head slot."""

    slot: int
    state_root: bytes                 # head (attested) state root
    finalized_root: bytes             # state.finalized_checkpoint.root
    finality_branch: List[bytes]      # gindex-105 branch over the head state
    finality_gindex: int = FINALIZED_ROOT_GINDEX
    sync_committee_root: bytes = b""  # htr(next_sync_committee)
    sync_branch: List[bytes] = field(default_factory=list)
    sync_gindex: int = NEXT_SYNC_COMMITTEE_GINDEX
    # combined witness: one multiproof over the head state for both
    # commitments (strictly smaller than the two branches summed)
    multi_gindices: List[int] = field(default_factory=list)
    multi_leaves: List[bytes] = field(default_factory=list)
    multi_proof: List[bytes] = field(default_factory=list)
    update: object = None             # spec.LightClientUpdate (None in phase0)
    signing_root: bytes = b""
    participant_pubkeys: List[bytes] = field(default_factory=list)
    verified: Optional[bool] = None   # sync-committee signature verdict

    @property
    def key(self) -> bytes:
        return proof_key(self.slot, self.state_root)


def build_update_artifact(
    spec,
    state,
    finalized_state,
    *,
    genesis_validators_root: bytes = b"\x00" * 32,
    fork_version=None,
    sign: Optional[Callable[[bytes], Tuple[Sequence[bool], bytes]]] = None,
    signing_committee=None,
) -> ProofArtifact:
    """Materialize one altair artifact from the head ``state`` and the
    ``finalized_state`` its checkpoint commits to.

    ``sign(signing_root) -> (bits, signature)`` supplies the sync-committee
    signature over the ATTESTED header (``update.finality_header``);
    ``signing_committee`` names the committee those bits index into
    (default: ``finalized_state.next_sync_committee`` — correct whenever
    the committee is stable across the snapshot/update periods, as in
    ``ProofWorld``). Without ``sign`` the update is unsigned (all-zero
    bits) and only useful for branch-level verification.
    """
    fin_state_root = bytes(finalized_state.hash_tree_root())
    fin_header = spec.BeaconBlockHeader(
        slot=finalized_state.slot, state_root=spec.Root(fin_state_root))
    fin_header_root = bytes(fin_header.hash_tree_root())
    assert bytes(state.finalized_checkpoint.root) == fin_header_root, (
        "head state's finalized checkpoint does not commit to "
        "finalized_state's header")

    state_root = bytes(state.hash_tree_root())
    attested = spec.BeaconBlockHeader(
        slot=state.slot, state_root=spec.Root(state_root))

    g_fin = int(get_generalized_index(
        type(state), "finalized_checkpoint", "root"))
    g_sync = int(get_generalized_index(type(state), "next_sync_committee"))
    assert g_fin == FINALIZED_ROOT_GINDEX and \
        g_sync == NEXT_SYNC_COMMITTEE_GINDEX

    # every head-state extraction — the finality branch AND the combined
    # multiproof — comes off ONE root hash with memoized node lookups
    # (the branch and the multiproof helpers share their upper tree)
    branches, leaves, proof = build_proof_bundle(
        state,
        paths=[("finalized_checkpoint", "root")],
        gindices=[g_fin, g_sync],
    )
    finality_branch = [
        bytes(n) for n in branches[("finalized_checkpoint", "root")]]
    # the committee branch authenticates against the FINALIZED header's
    # state root (validate_light_client_update checks it there)
    sync_branch = [
        bytes(n) for n in build_proof(finalized_state, "next_sync_committee")]

    if fork_version is None:
        fork_version = spec.config.GENESIS_FORK_VERSION
    domain = spec.compute_domain(
        spec.DOMAIN_SYNC_COMMITTEE, fork_version,
        spec.Root(genesis_validators_root))
    signing_root = bytes(spec.compute_signing_root(attested, domain))

    committee = (signing_committee if signing_committee is not None
                 else finalized_state.next_sync_committee)
    size = len(committee.pubkeys)
    if sign is not None:
        bits, signature = sign(signing_root)
    else:
        bits, signature = [False] * size, b"\x00" * 96
    participants = [
        bytes(pk) for bit, pk in zip(bits, committee.pubkeys) if bit]

    update = spec.LightClientUpdate(
        header=fin_header,
        next_sync_committee=finalized_state.next_sync_committee,
        next_sync_committee_branch=sync_branch,
        finality_header=attested,
        finality_branch=finality_branch,
        sync_committee_bits=bits,
        sync_committee_signature=spec.BLSSignature(bytes(signature)),
        fork_version=fork_version,
    )
    return ProofArtifact(
        slot=int(state.slot),
        state_root=state_root,
        finalized_root=fin_header_root,
        finality_branch=finality_branch,
        finality_gindex=g_fin,
        sync_committee_root=bytes(
            finalized_state.next_sync_committee.hash_tree_root()),
        sync_branch=sync_branch,
        sync_gindex=g_sync,
        multi_gindices=[g_fin, g_sync],
        multi_leaves=[bytes(b) for b in leaves],
        multi_proof=[bytes(b) for b in proof],
        update=update,
        signing_root=signing_root,
        participant_pubkeys=participants,
    )


def verify_artifact(
    spec,
    artifact: ProofArtifact,
    snapshot,
    genesis_validators_root: bytes,
    *,
    state_root: Optional[bytes] = None,
) -> None:
    """Full client-side verification; raises ``AssertionError`` on any
    mismatch. ``state_root`` overrides the artifact's claimed head root —
    the proof-smoke passes an independently re-Merkleized root here so no
    warm-cache state is trusted on the verify side."""
    root = bytes(artifact.state_root if state_root is None else state_root)
    # the spec-defined check: both branches + 2/3 period math + signature
    spec.validate_light_client_update(
        snapshot, artifact.update, spec.Root(bytes(genesis_validators_root)))
    # branch check against the EXTERNAL root (validate above only saw the
    # roots the update itself carries)
    g = artifact.finality_gindex
    assert spec.is_valid_merkle_branch(
        spec.Root(artifact.finalized_root),
        [spec.Bytes32(b) for b in artifact.finality_branch],
        floorlog2(g), subtree_index(g), spec.Root(root))
    assert bytes(artifact.update.finality_header.state_root) == root
    # the combined witness serves both commitments from one proof
    if artifact.multi_gindices:
        assert verify_merkle_multiproof(
            artifact.multi_leaves, artifact.multi_proof,
            artifact.multi_gindices, root)
        assert bytes(artifact.multi_leaves[0]) == bytes(
            artifact.finalized_root)
        assert bytes(artifact.multi_leaves[1]) == bytes(
            artifact.sync_committee_root)


def build_head_proof(spec, state) -> ProofArtifact:
    """The simnet (phase0) artifact shape: finalized-root branch only."""
    state_root = bytes(state.hash_tree_root())
    g_fin = int(get_generalized_index(
        type(state), "finalized_checkpoint", "root"))
    branch = [
        bytes(n) for n in build_proof(state, "finalized_checkpoint", "root")]
    return ProofArtifact(
        slot=int(state.slot),
        state_root=state_root,
        finalized_root=bytes(state.finalized_checkpoint.root),
        finality_branch=branch,
        finality_gindex=g_fin,
    )


def verify_head_proof(
    spec, artifact: ProofArtifact, trusted_state_root: bytes
) -> None:
    """Light-client check of a phase0 head proof against the client's own
    trusted state root (real SHA-256 re-hashing, no served state reuse);
    raises ``AssertionError`` on mismatch."""
    root = bytes(trusted_state_root)
    assert bytes(artifact.state_root) == root, "state root mismatch"
    g = artifact.finality_gindex
    assert spec.is_valid_merkle_branch(
        spec.Root(bytes(artifact.finalized_root)),
        [spec.Bytes32(b) for b in artifact.finality_branch],
        floorlog2(g), subtree_index(g), spec.Root(root)), \
        "finality branch invalid"


class ProofWorld:
    """Minimal self-consistent altair world for benches/smokes/tests: one
    sync committee held across the snapshot and update periods, a
    finalized state one period past the snapshot (so
    ``validate_light_client_update`` takes the non-trivial
    ``next_sync_committee`` path), and head states whose finalized
    checkpoint commits to it.

    Signatures use the sum-secret-key identity (``fleet_smoke`` pattern):
    the aggregate of all committee signatures equals one signature under
    ``sum(sks) % R``, so FastAggregateVerify over the full committee
    passes with a single signing operation.
    """

    def __init__(self, spec, *, sks=None,
                 genesis_validators_root: bytes = b"\x10" * 32,
                 validators: int = 0, pubkeys=None):
        from ..utils import bls

        self.spec = spec
        self._bls = bls
        size = int(spec.SYNC_COMMITTEE_SIZE)
        self.sks = list(sks) if sks is not None else [
            (i + 1) for i in range(size)]
        assert len(self.sks) == size
        # ``pubkeys``: SkToPk of ``sks``, derived elsewhere (a key pool of
        # spawned processes, at a mainnet committee's 512 seats)
        self.pubkeys = ([bytes(pk) for pk in pubkeys] if pubkeys is not None
                        else [bls.SkToPk(sk) for sk in self.sks])
        assert len(self.pubkeys) == size
        agg = bls.SkToPk(sum(self.sks) % bls.R)
        self.committee = spec.SyncCommittee(
            pubkeys=[spec.BLSPubkey(pk) for pk in self.pubkeys],
            aggregate_pubkey=spec.BLSPubkey(agg))
        self.genesis_validators_root = bytes(genesis_validators_root)
        # optional validator registry: gives the proved states a
        # realistically deep tree, so artifact-build timing exercises the
        # Merkleization plane (pubkeys are synthetic — branch extraction
        # and signing never read them)
        self.n_validators = int(validators)

        period_slots = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD) * \
            int(spec.SLOTS_PER_EPOCH)
        # snapshot header in period 0, finalized header in period 1:
        # update_period == snapshot_period + 1, so validation checks the
        # committee branch instead of accepting the all-zero placeholder
        self.finalized_slot = period_slots + 2
        fin = spec.BeaconState()
        fin.slot = spec.Slot(self.finalized_slot)
        fin.current_sync_committee = self.committee
        fin.next_sync_committee = self.committee
        # the registry's two views are built and rooted once; every state
        # of the world gets its own copy of them (_set_registry)
        self._registry = None
        if self.n_validators:
            fields = spec.BeaconState.fields()
            self._registry = {
                "validators": fields["validators"]([
                    spec.Validator(
                        pubkey=spec.BLSPubkey(
                            (i + 1).to_bytes(48, "little")),
                        withdrawal_credentials=spec.Bytes32(
                            (i + 1).to_bytes(32, "little")),
                        effective_balance=spec.Gwei(32 * 10**9),
                        activation_epoch=spec.Epoch(0),
                        exit_epoch=spec.Epoch(2**64 - 1),
                        withdrawable_epoch=spec.Epoch(2**64 - 1),
                    )
                    for i in range(self.n_validators)
                ]),
                "balances": fields["balances"](
                    [spec.Gwei(32 * 10**9)] * self.n_validators),
            }
            for view in self._registry.values():
                view.hash_tree_root()  # the copies inherit warm caches
            self._set_registry(fin)
        self.finalized_state = fin
        self.finalized_state_root = bytes(fin.hash_tree_root())
        fin_header = spec.BeaconBlockHeader(
            slot=fin.slot, state_root=spec.Root(self.finalized_state_root))
        self.finalized_header_root = bytes(fin_header.hash_tree_root())
        self.snapshot = spec.LightClientSnapshot(
            header=spec.BeaconBlockHeader(),
            current_sync_committee=self.committee,
            next_sync_committee=self.committee)

    def _set_registry(self, state) -> None:
        """Give ``state`` the world's registry, as the JAX package's SSZ
        assignment does: the state owns its copy, so a write to one state
        reaches no other. The assignment copies the prebuilt views in bulk
        (``ComplexSeries.copy``) with their warm merkle caches, not element
        by element."""
        for name, view in self._registry.items():
            setattr(state, name, view)

    def head_state(self, slot: int):
        """A head state at ``slot`` whose checkpoint commits to the
        world's finalized state."""
        spec = self.spec
        assert slot > self.finalized_slot
        state = spec.BeaconState()
        state.slot = spec.Slot(slot)
        state.current_sync_committee = self.committee
        state.next_sync_committee = self.committee
        if self._registry is not None:
            self._set_registry(state)
        state.finalized_checkpoint = spec.Checkpoint(
            epoch=spec.Epoch(
                self.finalized_slot // int(spec.SLOTS_PER_EPOCH)),
            root=spec.Root(self.finalized_header_root))
        return state

    def sign(self, signing_root: bytes):
        """Full-participation sync-committee signature (sum-sk identity)."""
        bls = self._bls
        sk = sum(self.sks) % bls.R
        return [True] * len(self.sks), bls.Sign(sk, bytes(signing_root))

    def build_artifact(self, slot: int, *, signed: bool = True):
        return build_update_artifact(
            self.spec, self.head_state(slot), self.finalized_state,
            genesis_validators_root=self.genesis_validators_root,
            sign=self.sign if signed else None)
