"""Light-client sync-protocol unittests
(spec: reference specs/altair/sync-protocol.md:108-195; scenario coverage
modeled on the reference's altair light-client suite, written for this
harness — branches are REAL SSZ proofs from utils/ssz/proofs.build_proof).
"""
from ...context import (
    ALTAIR, MINIMAL, always_bls, expect_assertion_error, spec_state_test,
    with_phases, with_presets,
)
from ...helpers.keys import privkeys
from ...helpers.state import transition_to
from ...helpers.sync_committee import get_committee_indices


def _current_header(spec, state):
    # synthetic header at the state's slot (no real blocks are applied in
    # these unittests; only the slot ordering and roots matter)
    return spec.BeaconBlockHeader(
        slot=state.slot,
        state_root=spec.hash_tree_root(state),
    )


def _empty_branches(spec):
    nsc = [spec.Bytes32()] * int(spec.floorlog2(spec.NEXT_SYNC_COMMITTEE_INDEX))
    fin = [spec.Bytes32()] * int(spec.floorlog2(spec.FINALIZED_ROOT_INDEX))
    return nsc, fin


def _sign_header(spec, state, header, participants):
    domain = spec.compute_domain(
        spec.DOMAIN_SYNC_COMMITTEE, state.fork.current_version,
        state.genesis_validators_root,
    )
    signing_root = spec.compute_signing_root(header, domain)
    return spec.bls.Aggregate([
        spec.bls.Sign(privkeys[i], signing_root) for i in participants
    ])


def _snapshot_for(spec, state, header=None):
    return spec.LightClientSnapshot(
        header=header or spec.BeaconBlockHeader(),
        current_sync_committee=state.current_sync_committee,
        next_sync_committee=state.next_sync_committee,
    )


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_process_light_client_update_not_timeout(spec, state):
    # an update inside the same period without a finality proof is stored in
    # valid_updates but not applied
    transition_to(spec, state, state.slot + 2)
    snapshot = _snapshot_for(spec, state)
    store = spec.LightClientStore(snapshot=snapshot, valid_updates=set())

    update_header = _current_header(spec, state)
    committee_indices = get_committee_indices(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)
    update = spec.LightClientUpdate(
        header=update_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=spec.BeaconBlockHeader(),
        finality_branch=fin_branch,
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        # header itself is signed when no finality header is present
        sync_committee_signature=_sign_header(spec, state, update_header, committee_indices),
        fork_version=state.fork.current_version,
    )

    pre_snapshot_root = spec.hash_tree_root(store.snapshot)
    spec.process_light_client_update(
        store, update, state.slot, state.genesis_validators_root
    )
    assert len(store.valid_updates) == 1
    assert spec.hash_tree_root(store.snapshot) == pre_snapshot_root  # not applied


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_process_light_client_update_finality_updated(spec, state):
    # with a finality proof and a supermajority signature the update applies
    from ....utils.ssz.proofs import build_proof

    # give the state a finalized checkpoint holding a real header root
    transition_to(spec, state, state.slot + spec.SLOTS_PER_EPOCH)
    finalized_header = _current_header(spec, state)
    state.finalized_checkpoint = spec.Checkpoint(
        epoch=spec.compute_epoch_at_slot(finalized_header.slot),
        root=spec.hash_tree_root(finalized_header),
    )
    finality_branch = build_proof(state, 'finalized_checkpoint', 'root')

    # the finality header covers the state that contains the checkpoint
    finality_header = spec.BeaconBlockHeader(
        slot=state.slot + 1,
        state_root=spec.hash_tree_root(state),
    )

    store = spec.LightClientStore(
        snapshot=_snapshot_for(spec, state), valid_updates=set()
    )
    committee_indices = get_committee_indices(spec, state)
    nsc_branch, _ = _empty_branches(spec)
    update = spec.LightClientUpdate(
        header=finalized_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=finality_header,
        finality_branch=finality_branch,
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        # the finality header is the signed header in the finalized flow
        sync_committee_signature=_sign_header(spec, state, finality_header, committee_indices),
        fork_version=state.fork.current_version,
    )

    spec.process_light_client_update(
        store, update, finality_header.slot, state.genesis_validators_root
    )
    # 2/3 quorum + finality proof -> applied, queue flushed
    assert store.snapshot.header == finalized_header
    assert len(store.valid_updates) == 0


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
@always_bls
def test_validate_light_client_update_bad_signature_rejected(spec, state):
    transition_to(spec, state, state.slot + 2)
    snapshot = _snapshot_for(spec, state)
    update_header = _current_header(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)
    update = spec.LightClientUpdate(
        header=update_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=spec.BeaconBlockHeader(),
        finality_branch=fin_branch,
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        sync_committee_signature=spec.BLSSignature(),  # zeroed
    )
    expect_assertion_error(lambda: spec.validate_light_client_update(
        snapshot, update, state.genesis_validators_root
    ))


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_validate_light_client_update_bad_finality_proof_rejected(spec, state):
    transition_to(spec, state, state.slot + spec.SLOTS_PER_EPOCH)
    finalized_header = _current_header(spec, state)
    state.finalized_checkpoint = spec.Checkpoint(
        epoch=spec.compute_epoch_at_slot(finalized_header.slot),
        root=spec.hash_tree_root(finalized_header),
    )
    finality_header = spec.BeaconBlockHeader(
        slot=state.slot + 1,
        state_root=spec.hash_tree_root(state),
    )
    snapshot = _snapshot_for(spec, state)
    committee_indices = get_committee_indices(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)  # zero branch = bad proof
    update = spec.LightClientUpdate(
        header=finalized_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=finality_header,
        finality_branch=fin_branch,
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        sync_committee_signature=_sign_header(spec, state, finality_header, committee_indices),
        fork_version=state.fork.current_version,
    )
    expect_assertion_error(lambda: spec.validate_light_client_update(
        snapshot, update, state.genesis_validators_root
    ))


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_process_light_client_update_timeout_forces_best(spec, state):
    """After a full sync-committee period without finality, the best queued
    update (most participation) is force-applied
    (sync-protocol.md:186-195)."""
    transition_to(spec, state, state.slot + 2)
    snapshot = _snapshot_for(spec, state)
    store = spec.LightClientStore(snapshot=snapshot, valid_updates=set())
    committee_indices = get_committee_indices(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)
    size = int(spec.SYNC_COMMITTEE_SIZE)

    def make_update(n_participants, slot):
        header = spec.BeaconBlockHeader(
            slot=slot, state_root=spec.hash_tree_root(state)
        )
        bits = [i < n_participants for i in range(size)]
        participants = [committee_indices[i] for i in range(n_participants)]
        return spec.LightClientUpdate(
            header=header,
            next_sync_committee=state.next_sync_committee,
            next_sync_committee_branch=nsc_branch,
            finality_header=spec.BeaconBlockHeader(),
            finality_branch=fin_branch,
            sync_committee_bits=bits,
            sync_committee_signature=_sign_header(
                spec, state, header, participants
            ),
            fork_version=state.fork.current_version,
        )

    # two queued updates without finality proofs; neither applies yet
    weak = make_update(size // 3, state.slot)
    strong = make_update(size // 2, state.slot + 1)  # < 2/3: no quorum apply
    spec.process_light_client_update(
        store, weak, state.slot, state.genesis_validators_root
    )
    spec.process_light_client_update(
        store, strong, state.slot, state.genesis_validators_root
    )
    assert len(store.valid_updates) == 2
    assert store.snapshot.header == spec.BeaconBlockHeader()

    # past the update timeout, feeding any update force-applies the BEST one
    late_slot = (
        int(state.slot)
        + int(spec.SLOTS_PER_EPOCH * spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD) + 1
    )
    another = make_update(size // 3, state.slot)
    spec.process_light_client_update(
        store, another, spec.Slot(late_slot), state.genesis_validators_root
    )
    assert store.snapshot.header == strong.header  # most participation won
    assert len(store.valid_updates) == 0


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_validate_update_skipping_period_rejected(spec, state):
    # an update more than one sync-committee period ahead of the snapshot
    # cannot be validated (sync-protocol.md: update_period must be the
    # snapshot's or the next one)
    transition_to(spec, state, state.slot + 2)
    snapshot = _snapshot_for(spec, state, header=_current_header(spec, state))

    period_slots = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD) * int(
        spec.SLOTS_PER_EPOCH
    )
    far_header = spec.BeaconBlockHeader(
        slot=state.slot + 2 * period_slots,
        state_root=spec.Root(b"\x99" * 32),
    )
    committee_indices = get_committee_indices(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)
    update = spec.LightClientUpdate(
        header=far_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=spec.BeaconBlockHeader(),
        finality_branch=fin_branch,
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        sync_committee_signature=_sign_header(spec, state, far_header, committee_indices),
        fork_version=state.fork.current_version,
    )
    expect_assertion_error(
        lambda: spec.validate_light_client_update(
            snapshot, update, state.genesis_validators_root
        )
    )


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_validate_update_insufficient_participation_rejected(spec, state):
    # fewer than MIN_SYNC_COMMITTEE_PARTICIPANTS set bits fails before any
    # signature work
    transition_to(spec, state, state.slot + 2)
    snapshot = _snapshot_for(spec, state)
    update_header = _current_header(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)
    bits = [False] * int(spec.SYNC_COMMITTEE_SIZE)
    update = spec.LightClientUpdate(
        header=update_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=spec.BeaconBlockHeader(),
        finality_branch=fin_branch,
        sync_committee_bits=bits,
        sync_committee_signature=spec.G2_POINT_AT_INFINITY,
        fork_version=state.fork.current_version,
    )
    expect_assertion_error(
        lambda: spec.validate_light_client_update(
            snapshot, update, state.genesis_validators_root
        )
    )


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="pure-python sync committee signing")
@spec_state_test
def test_validate_update_nonzero_committee_branch_same_period_rejected(spec, state):
    # inside the snapshot's own period the next-sync-committee branch MUST be
    # zeroed — a real-looking branch is a malformed update, not a bonus proof
    transition_to(spec, state, state.slot + 2)
    snapshot = _snapshot_for(spec, state)
    update_header = _current_header(spec, state)
    committee_indices = get_committee_indices(spec, state)
    nsc_branch, fin_branch = _empty_branches(spec)
    nsc_branch = [spec.Bytes32(b"\x01" * 32)] + nsc_branch[1:]
    update = spec.LightClientUpdate(
        header=update_header,
        next_sync_committee=state.next_sync_committee,
        next_sync_committee_branch=nsc_branch,
        finality_header=spec.BeaconBlockHeader(),
        finality_branch=fin_branch,
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        sync_committee_signature=_sign_header(spec, state, update_header, committee_indices),
        fork_version=state.fork.current_version,
    )
    expect_assertion_error(
        lambda: spec.validate_light_client_update(
            snapshot, update, state.genesis_validators_root
        )
    )
