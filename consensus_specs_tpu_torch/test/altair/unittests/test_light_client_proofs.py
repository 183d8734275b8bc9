"""Light-client Merkle-proof unit tests: the two sync-protocol branches
(next_sync_committee @ gindex 55, finalized_checkpoint.root @ gindex 105 —
reference specs/altair/sync-protocol.md:67-85, setup.py:476-481) built from
a REAL BeaconState and checked with the spec's own is_valid_merkle_branch,
plus one combined multiproof covering both paths at once (this framework's
ssz/merkle-proofs.md:249+ engine — beyond what the reference tests)."""
from ...context import ALTAIR, spec_state_test, with_phases
from ...helpers.state import next_epoch

from ....utils.ssz.gindex import get_generalized_index
from ....utils.ssz.proofs import (
    build_multiproof,
    build_proof,
    verify_merkle_multiproof,
)


def _floorlog2(x: int) -> int:
    return x.bit_length() - 1


@with_phases([ALTAIR])
@spec_state_test
def test_next_sync_committee_merkle_proof(spec, state):
    next_epoch(spec, state)
    gindex = int(spec.NEXT_SYNC_COMMITTEE_INDEX)
    branch = build_proof(state, "next_sync_committee")
    depth = _floorlog2(gindex)
    assert len(branch) == depth
    assert spec.is_valid_merkle_branch(
        leaf=spec.hash_tree_root(state.next_sync_committee),
        branch=branch,
        depth=depth,
        index=gindex % (1 << depth),
        root=spec.hash_tree_root(state),
    )


@with_phases([ALTAIR])
@spec_state_test
def test_finality_root_merkle_proof(spec, state):
    # give the finalized checkpoint a non-default root so the proof binds
    # real content, not a zero leaf
    state.finalized_checkpoint.root = spec.Root(b"\x5a" * 32)
    gindex = int(spec.FINALIZED_ROOT_INDEX)
    branch = build_proof(state, "finalized_checkpoint", "root")
    depth = _floorlog2(gindex)
    assert len(branch) == depth
    assert spec.is_valid_merkle_branch(
        leaf=state.finalized_checkpoint.root,
        branch=branch,
        depth=depth,
        index=gindex % (1 << depth),
        root=spec.hash_tree_root(state),
    )


@with_phases([ALTAIR])
@spec_state_test
def test_light_client_combined_multiproof(spec, state):
    # one multiproof serving BOTH light-client branches: fewer total hashes
    # than two single proofs, verified against the state root
    state.finalized_checkpoint.root = spec.Root(b"\xa5" * 32)
    cls = type(state)
    g_sync = get_generalized_index(cls, "next_sync_committee")
    g_fin = get_generalized_index(cls, "finalized_checkpoint", "root")
    assert (int(g_sync), int(g_fin)) == (
        int(spec.NEXT_SYNC_COMMITTEE_INDEX),
        int(spec.FINALIZED_ROOT_INDEX),
    )
    indices = [g_sync, g_fin]
    leaves, proof = build_multiproof(state, indices)
    assert list(leaves) == [
        bytes(spec.hash_tree_root(state.next_sync_committee)),
        bytes(state.finalized_checkpoint.root),
    ]
    assert verify_merkle_multiproof(
        leaves, proof, indices, bytes(spec.hash_tree_root(state))
    )
    # tampering with either leaf must break it
    bad = [leaves[0], b"\x00" * 32]
    assert not verify_merkle_multiproof(
        bad, proof, indices, bytes(spec.hash_tree_root(state))
    )
