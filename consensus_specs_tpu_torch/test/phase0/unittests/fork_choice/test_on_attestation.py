"""on_attestation / on_tick handler unit tests
(spec: reference specs/phase0/fork-choice.md:263-337, :393-410; scenario
coverage modeled on the reference's phase0/unittests/fork_choice tree,
written for this harness)."""
from ....context import spec_state_test, with_all_phases
from ....helpers.attestations import get_valid_attestation
from ....helpers.block import build_empty_block_for_next_slot
from ....helpers.fork_choice import (
    get_genesis_forkchoice_store, run_on_attestation, slot_time,
)
from ....helpers.state import state_transition_and_sign_block


def _store_with_block(spec, state, extra_slots=0):
    """Store + one applied block; store clock at block slot + extra_slots."""
    store = get_genesis_forkchoice_store(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    spec.on_tick(store, slot_time(spec, store, block.slot + extra_slots))
    spec.on_block(store, signed_block)
    return store, block


@with_all_phases
@spec_state_test
def test_on_attestation_current_epoch(spec, state):
    store, block = _store_with_block(spec, state, extra_slots=1)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    run_on_attestation(spec, store, attestation)
    # every attester recorded an LMD vote for the block
    indexed = spec.get_indexed_attestation(state, attestation)
    for i in indexed.attesting_indices:
        assert store.latest_messages[i] == spec.LatestMessage(
            epoch=attestation.data.target.epoch,
            root=attestation.data.beacon_block_root,
        )


@with_all_phases
@spec_state_test
def test_on_attestation_same_slot_invalid(spec, state):
    # attestations only affect the fork choice of SUBSEQUENT slots
    # (fork-choice.md:286-290)
    store, block = _store_with_block(spec, state, extra_slots=0)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    run_on_attestation(spec, store, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_on_attestation_future_epoch_invalid(spec, state):
    store, block = _store_with_block(spec, state, extra_slots=1)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    # target epoch beyond the store clock must be delayed
    attestation.data.target.epoch = spec.get_current_epoch(state) + 3
    run_on_attestation(spec, store, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_on_attestation_mismatched_target_epoch_invalid(spec, state):
    store, block = _store_with_block(spec, state, extra_slots=1)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    # slot and target epoch must agree (fork-choice.md:281)
    attestation.data.slot = attestation.data.slot + spec.SLOTS_PER_EPOCH
    run_on_attestation(spec, store, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_on_attestation_unknown_target_root_invalid(spec, state):
    store, block = _store_with_block(spec, state, extra_slots=1)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    attestation.data.target.root = b'\x57' * 32
    run_on_attestation(spec, store, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_on_attestation_unknown_beacon_block_root_invalid(spec, state):
    store, block = _store_with_block(spec, state, extra_slots=1)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    attestation.data.beacon_block_root = b'\x57' * 32
    run_on_attestation(spec, store, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_on_attestation_block_after_attestation_slot_invalid(spec, state):
    store, block = _store_with_block(spec, state, extra_slots=1)
    attestation = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    # point the LMD vote at the block but claim an EARLIER slot than it
    attestation.data.slot = block.slot - 1
    attestation.data.target.epoch = spec.compute_epoch_at_slot(attestation.data.slot)
    run_on_attestation(spec, store, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_on_tick_new_epoch_promotes_best_justified(spec, state):
    # (fork-choice.md:320-337)
    store = get_genesis_forkchoice_store(spec, state)
    genesis_root = store.justified_checkpoint.root
    better = spec.Checkpoint(epoch=1, root=genesis_root)
    store.best_justified_checkpoint = better
    # mid-epoch tick: no promotion
    spec.on_tick(store, slot_time(spec, store, 1))
    assert store.justified_checkpoint != better
    # epoch-boundary tick: promoted (ancestor check passes — same root chain)
    spec.on_tick(store, slot_time(spec, store, spec.SLOTS_PER_EPOCH))
    assert store.justified_checkpoint == better


@with_all_phases
@spec_state_test
def test_on_tick_mid_epoch_no_promotion(spec, state):
    store = get_genesis_forkchoice_store(spec, state)
    better = spec.Checkpoint(epoch=1, root=store.justified_checkpoint.root)
    store.best_justified_checkpoint = better
    # tick to a mid-epoch slot only
    spec.on_tick(store, slot_time(spec, store, spec.SLOTS_PER_EPOCH - 1))
    assert store.justified_checkpoint != better


@with_all_phases
@spec_state_test
def test_on_attestation_same_epoch_does_not_override(spec, state):
    # LMD stores at most one message per validator and replaces it only
    # for a STRICTLY newer target epoch (fork-choice.md on_attestation):
    # the same committee voting for a competing block in the same epoch
    # must leave the first votes standing
    store = get_genesis_forkchoice_store(spec, state)
    state_a, state_b = state.copy(), state.copy()
    block_a = build_empty_block_for_next_slot(spec, state_a)
    block_a.body.graffiti = b"\x0a" + b"\x00" * 31
    signed_a = state_transition_and_sign_block(spec, state_a, block_a)
    block_b = build_empty_block_for_next_slot(spec, state_b)
    block_b.body.graffiti = b"\x0b" + b"\x00" * 31
    signed_b = state_transition_and_sign_block(spec, state_b, block_b)
    spec.on_tick(store, slot_time(spec, store, block_a.slot + 1))
    spec.on_block(store, signed_a)
    spec.on_block(store, signed_b)

    att_a = get_valid_attestation(spec, state_a, slot=block_a.slot, signed=True)
    run_on_attestation(spec, store, att_a)
    root_a = att_a.data.beacon_block_root
    voters = list(spec.get_indexed_attestation(state_a, att_a).attesting_indices)

    # the two forks share the epoch's shuffling, so the SAME validators
    # now vote for block B at the same target epoch
    att_b = get_valid_attestation(spec, state_b, slot=block_b.slot, signed=True)
    assert att_b.data.target.epoch == att_a.data.target.epoch
    assert att_b.data.beacon_block_root != root_a
    run_on_attestation(spec, store, att_b)

    for v in voters:
        assert store.latest_messages[v].root == root_a


@with_all_phases
@spec_state_test
def test_on_attestation_newer_epoch_overrides(spec, state):
    # ...but the same validator's NEXT-epoch vote replaces the stored
    # message — the property that lets honest validators move the head
    from ....helpers.state import next_epoch, transition_to

    store = get_genesis_forkchoice_store(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    signed = state_transition_and_sign_block(spec, state, block)
    spec.on_tick(store, slot_time(spec, store, block.slot + 1))
    spec.on_block(store, signed)

    att1 = get_valid_attestation(spec, state, slot=block.slot, signed=True)
    run_on_attestation(spec, store, att1)
    victim = int(spec.get_indexed_attestation(state, att1).attesting_indices[0])
    first = store.latest_messages[victim]

    # find the victim's committee seat in the next epoch
    next_epoch(spec, state)
    epoch = spec.get_current_epoch(state)
    start = spec.compute_start_slot_at_epoch(epoch)
    seat = next(
        (slot, ci)
        for slot in range(start, start + spec.SLOTS_PER_EPOCH)
        for ci in range(spec.get_committee_count_per_slot(state, epoch))
        if victim in spec.get_beacon_committee(state, slot, ci)
    )
    transition_to(spec, state, seat[0])
    att2 = get_valid_attestation(
        spec, state, slot=seat[0], index=seat[1], signed=True,
        filter_participant_set=lambda committee: {victim},
    )
    spec.on_tick(store, slot_time(spec, store, seat[0] + 1))
    run_on_attestation(spec, store, att2)

    got = store.latest_messages[victim]
    assert got.epoch == att2.data.target.epoch
    assert got.epoch > first.epoch
