"""process_attestation handler tests
(reference: test/phase0/block_processing/test_process_attestation.py).

Provenance: adapted from the reference's test/phase0/block_processing/test_process_attestation.py — scenario code and comments largely follow the reference test suite; newer suites in this repo are original.
"""
from ...context import always_bls, never_bls, spec_state_test, with_all_phases
from ...helpers.attestations import (
    get_valid_attestation, run_attestation_processing, sign_attestation,
)
from ...helpers.state import next_epoch, next_slots


@with_all_phases
@spec_state_test
def test_success(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_success_multi_proposer_index_iterations(spec, state):
    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 2)
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_success_previous_epoch(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_epoch(spec, state)

    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_attestation_signature(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_empty_participants_zeroes_sig(spec, state):
    attestation = get_valid_attestation(spec, state, filter_participant_set=lambda comm: [])
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_empty_participants_seemingly_valid_sig(spec, state):
    attestation = get_valid_attestation(spec, state, filter_participant_set=lambda comm: [])
    # Special BLS value, valid for zero pubkeys on some implementations
    attestation.signature = spec.BLSSignature(b'\xc0' + b'\x00' * 95)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_before_inclusion_delay(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    # do not increment slot to allow for inclusion delay

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_after_epoch_slots(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)

    # increment past latest inclusion slot
    next_slots(spec, state, spec.SLOTS_PER_EPOCH + 1)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_old_source_epoch(spec, state):
    state.slot = spec.SLOTS_PER_EPOCH * 5
    state.finalized_checkpoint.epoch = 2
    state.previous_justified_checkpoint.epoch = 3
    state.current_justified_checkpoint.epoch = 4
    attestation = get_valid_attestation(spec, state, slot=(spec.SLOTS_PER_EPOCH * 3) + 1)

    # test logic sanity check: make sure the attestation is pointing to oldest known source epoch
    assert attestation.data.source.epoch == state.previous_justified_checkpoint.epoch

    # Now set the attestation source epoch to an invalid value: the oldest known FINALIZED epoch
    attestation.data.source.epoch = state.finalized_checkpoint.epoch

    sign_attestation(spec, state, attestation)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_wrong_index_for_committee_signature(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    attestation.data.index += 1

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@never_bls
def test_invalid_index(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    # Invalid index: off by one (with respect to valid range) on purpose
    attestation.data.index = spec.get_committee_count_per_slot(state, spec.get_current_epoch(state))

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_mismatched_target_and_slot(spec, state):
    next_epoch(spec, state)
    next_epoch(spec, state)

    attestation = get_valid_attestation(spec, state, slot=state.slot - spec.SLOTS_PER_EPOCH)
    attestation.data.slot = attestation.data.slot - spec.SLOTS_PER_EPOCH

    sign_attestation(spec, state, attestation)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_old_target_epoch(spec, state):
    assert spec.MIN_ATTESTATION_INCLUSION_DELAY < spec.SLOTS_PER_EPOCH * 2

    attestation = get_valid_attestation(spec, state, signed=True)

    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 2)  # target epoch will be too old to handle

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_future_target_epoch(spec, state):
    assert spec.MIN_ATTESTATION_INCLUSION_DELAY < spec.SLOTS_PER_EPOCH * 2

    attestation = get_valid_attestation(spec, state)

    participants = spec.get_attesting_indices(
        state,
        attestation.data,
        attestation.aggregation_bits
    )
    attestation.data.target.epoch = spec.get_current_epoch(state) + 1  # target epoch will be too new to handle

    # manually add signature for correct participants
    attestation.signature = sign_aggregate_attestation_for(spec, state, attestation.data, participants)

    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


def sign_aggregate_attestation_for(spec, state, data, participants):
    from ...helpers.attestations import sign_aggregate_attestation

    return sign_aggregate_attestation(spec, state, data, participants)


@with_all_phases
@spec_state_test
def test_new_source_epoch(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    attestation.data.source.epoch += 1

    sign_attestation(spec, state, attestation)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_current_source_root(spec, state):
    state.slot = spec.SLOTS_PER_EPOCH * 5 + 2
    state.finalized_checkpoint.epoch = 2

    state.previous_justified_checkpoint = spec.Checkpoint(epoch=3, root=b'\x01' * 32)
    state.current_justified_checkpoint = spec.Checkpoint(epoch=4, root=b'\x32' * 32)

    # attestation inside the current epoch -> source must be current justified
    attestation = get_valid_attestation(spec, state, slot=(spec.SLOTS_PER_EPOCH * 5) + 1)

    # Test logic sanity checks:
    assert state.current_justified_checkpoint.root != state.previous_justified_checkpoint.root
    assert attestation.data.source.root == state.current_justified_checkpoint.root

    # Make attestation source root invalid: should be current justified, not previous one
    attestation.data.source.root = state.previous_justified_checkpoint.root

    sign_attestation(spec, state, attestation)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_bad_source_root(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    attestation.data.source.root = b'\x42' * 32

    sign_attestation(spec, state, attestation)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_too_many_aggregation_bits(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    # one too many bits
    attestation.aggregation_bits.append(0b0)

    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_too_few_aggregation_bits(spec, state):
    attestation = get_valid_attestation(spec, state)
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)

    attestation.aggregation_bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](
        [0b1] + [0b0] * (len(attestation.aggregation_bits) - 1)
    )

    sign_attestation(spec, state, attestation)

    # one too few bits
    attestation.aggregation_bits = spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](
        attestation.aggregation_bits[:-1]
    )

    yield from run_attestation_processing(spec, state, attestation, valid=False)


def _run_wrongness_delay_variant(spec, state, delay, wrong_head=False, wrong_target=False):
    """Wrong-head/wrong-target attestations are processable at any legal
    inclusion delay — wrongness only costs flags/rewards, not validity
    (phase0 checks neither root; altair drops the matching flags)."""
    attestation = get_valid_attestation(spec, state, signed=False)
    if wrong_head:
        attestation.data.beacon_block_root = b'\x42' * 32
    if wrong_target:
        attestation.data.target.root = b'\x42' * 32
    sign_attestation(spec, state, attestation)
    next_slots(spec, state, delay)
    yield from run_attestation_processing(spec, state, attestation)


def _sqrt_epoch(spec):
    return int(spec.integer_squareroot(spec.uint64(int(spec.SLOTS_PER_EPOCH))))


@with_all_phases
@spec_state_test
def test_correct_sqrt_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(spec, state, _sqrt_epoch(spec))


@with_all_phases
@spec_state_test
def test_correct_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(spec, state, int(spec.SLOTS_PER_EPOCH))


@with_all_phases
@spec_state_test
def test_incorrect_head_min_inclusion_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, int(spec.MIN_ATTESTATION_INCLUSION_DELAY), wrong_head=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_head_sqrt_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, _sqrt_epoch(spec), wrong_head=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_head_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, int(spec.SLOTS_PER_EPOCH), wrong_head=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_head_and_target_min_inclusion_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, int(spec.MIN_ATTESTATION_INCLUSION_DELAY),
        wrong_head=True, wrong_target=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_head_and_target_sqrt_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, _sqrt_epoch(spec), wrong_head=True, wrong_target=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_head_and_target_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, int(spec.SLOTS_PER_EPOCH), wrong_head=True, wrong_target=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_target_min_inclusion_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, int(spec.MIN_ATTESTATION_INCLUSION_DELAY), wrong_target=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_target_sqrt_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, _sqrt_epoch(spec), wrong_target=True,
    )


@with_all_phases
@spec_state_test
def test_incorrect_target_epoch_delay(spec, state):
    yield from _run_wrongness_delay_variant(
        spec, state, int(spec.SLOTS_PER_EPOCH), wrong_target=True,
    )


@with_all_phases
@spec_state_test
def test_empty_participants_zeroed_sig(spec, state):
    attestation = get_valid_attestation(
        spec, state, filter_participant_set=lambda participants: set()
    )
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    attestation.signature = spec.BLSSignature()
    # zero participants: indexed attestation has no attesters -> invalid
    yield from run_attestation_processing(spec, state, attestation, valid=False)


# -- full-epoch inclusion delays, source-root edge
#    cases, and nonzero-index slot variants ---------------------------------


def _aged_attestation(spec, state, mutator=None):
    """A signed attestation included exactly SLOTS_PER_EPOCH after its
    slot — the maximum inclusion distance that is still valid."""
    attestation = get_valid_attestation(spec, state, signed=False)
    if mutator is not None:
        mutator(attestation)
    sign_attestation(spec, state, attestation)
    next_slots(spec, state, spec.SLOTS_PER_EPOCH)
    return attestation


@with_all_phases
@spec_state_test
def test_correct_after_epoch_delay(spec, state):
    next_epoch(spec, state)  # leave the genesis epoch first
    attestation = _aged_attestation(spec, state)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_incorrect_head_after_epoch_delay(spec, state):
    next_epoch(spec, state)

    def bad_head(att):
        att.data.beacon_block_root = b"\x37" * 32

    attestation = _aged_attestation(spec, state, bad_head)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_incorrect_target_after_epoch_delay(spec, state):
    next_epoch(spec, state)

    def bad_target(att):
        att.data.target.root = b"\x38" * 32

    attestation = _aged_attestation(spec, state, bad_target)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_incorrect_head_and_target_after_epoch_delay(spec, state):
    next_epoch(spec, state)

    def bad_both(att):
        att.data.beacon_block_root = b"\x39" * 32
        att.data.target.root = b"\x3a" * 32

    attestation = _aged_attestation(spec, state, bad_both)
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_invalid_previous_source_root(spec, state):
    # previous-epoch vote whose source ROOT disagrees with the state's
    # previous justified checkpoint (epoch matches) -> rejected
    next_epoch(spec, state)
    next_epoch(spec, state)
    attestation = get_valid_attestation(
        spec, state, slot=state.slot - spec.SLOTS_PER_EPOCH, signed=False
    )
    assert attestation.data.target.epoch == spec.get_previous_epoch(state)
    attestation.data.source.root = b"\x45" * 32
    sign_attestation(spec, state, attestation)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_source_root_is_target_root(spec, state):
    # degenerate-but-legal vote shape where source.root happens to equal
    # target.root (self-referential chains near genesis)
    attestation = get_valid_attestation(spec, state, signed=False)
    attestation.data.source.root = attestation.data.target.root
    # only valid if the justified checkpoint root actually matches
    if attestation.data.source.root != state.current_justified_checkpoint.root:
        sign_attestation(spec, state, attestation)
        next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
        yield from run_attestation_processing(spec, state, attestation, valid=False)
    else:
        sign_attestation(spec, state, attestation)
        next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
        yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_wrong_index_for_slot_0(spec, state):
    # index >= committee count for the slot -> rejected
    committee_count = spec.get_committee_count_per_slot(
        state, spec.get_current_epoch(state)
    )
    attestation = get_valid_attestation(spec, state, signed=True)
    attestation.data.index = committee_count  # one past the last
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_wrong_index_for_slot_1(spec, state):
    committee_count = spec.get_committee_count_per_slot(
        state, spec.get_current_epoch(state)
    )
    attestation = get_valid_attestation(spec, state, signed=True)
    attestation.data.index = spec.MAX_COMMITTEES_PER_SLOT - 1
    if committee_count > spec.MAX_COMMITTEES_PER_SLOT - 1:
        import pytest

        pytest.skip("every index is in range on this preset")
    next_slots(spec, state, spec.MIN_ATTESTATION_INCLUSION_DELAY)
    yield from run_attestation_processing(spec, state, attestation, valid=False)
