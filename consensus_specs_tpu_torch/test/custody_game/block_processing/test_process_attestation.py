"""Attestation processing under the custody fork (scenario space of the
reference's custody_game/block_processing/test_process_attestation.py,
written for this harness — the custody pipeline inherits sharding's
extended attestation handler)."""
from ...context import CUSTODY_GAME, always_bls, expect_assertion_error, spec_state_test, with_phases
from ...helpers.attestations import get_valid_attestation, sign_attestation
from ...helpers.state import next_epoch, next_slot, next_slots


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_attestation_success(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)
    attestation = get_valid_attestation(spec, state, slot=state.slot - 1, signed=True)

    yield 'pre', state
    yield 'attestation', attestation
    spec.process_attestation(state, attestation)
    yield 'post', state

    attesting = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    )
    for index in attesting:
        assert spec.has_flag(
            state.current_epoch_participation[index], spec.TIMELY_SOURCE_FLAG_INDEX
        )


@with_phases([CUSTODY_GAME])
@spec_state_test
@always_bls
def test_attestation_success_real_signature(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)
    attestation = get_valid_attestation(spec, state, slot=state.slot - 1, signed=True)
    yield 'pre', state
    yield 'attestation', attestation
    spec.process_attestation(state, attestation)
    yield 'post', state


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_attestation_previous_epoch(spec, state):
    next_epoch(spec, state)
    slot = state.slot  # first slot of the epoch
    attestation = get_valid_attestation(spec, state, slot=slot, signed=False)
    next_slots(spec, state, int(spec.SLOTS_PER_EPOCH))  # crosses into next epoch
    sign_attestation(spec, state, attestation)

    yield 'pre', state
    yield 'attestation', attestation
    spec.process_attestation(state, attestation)
    yield 'post', state


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_attestation_bad_committee_index(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)
    attestation = get_valid_attestation(spec, state, slot=state.slot - 1, signed=False)
    attestation.data.index = spec.get_committee_count_per_slot(
        state, spec.get_current_epoch(state)
    )
    yield 'pre', state
    yield 'attestation', attestation
    expect_assertion_error(lambda: spec.process_attestation(state, attestation))
    yield 'post', None


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_attestation_before_inclusion_delay(spec, state):
    next_epoch(spec, state)
    attestation = get_valid_attestation(spec, state, slot=state.slot, signed=True)
    # no slots elapsed since the attested slot
    yield 'pre', state
    yield 'attestation', attestation
    expect_assertion_error(lambda: spec.process_attestation(state, attestation))
    yield 'post', None
