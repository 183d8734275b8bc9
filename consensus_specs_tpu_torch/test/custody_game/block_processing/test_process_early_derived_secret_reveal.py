"""process_early_derived_secret_reveal tests (scenario coverage modeled on
the reference's dormant custody suite; reference
specs/custody_game/beacon-chain.md:570-610)."""
from ...context import (
    CUSTODY_GAME,
    always_bls,
    expect_assertion_error,
    spec_state_test,
    with_phases,
)
from ...helpers.custody_game import get_valid_early_derived_secret_reveal
from ...helpers.state import next_epoch


def run_early_derived_secret_reveal_processing(spec, state, reveal, valid=True):
    yield 'pre', state
    yield 'early_derived_secret_reveal', reveal

    if not valid:
        expect_assertion_error(
            lambda: spec.process_early_derived_secret_reveal(state, reveal)
        )
        yield 'post', None
        return

    spec.process_early_derived_secret_reveal(state, reveal)
    yield 'post', state


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_early_reveal_full_slashing_when_within_custody_window(spec, state):
    next_epoch(spec, state)
    # default epoch = current + CUSTODY_PERIOD_TO_RANDAO_PADDING: could be a
    # live custody round key -> full slashing
    reveal = get_valid_early_derived_secret_reveal(spec, state)
    yield from run_early_derived_secret_reveal_processing(spec, state, reveal)
    assert state.validators[reveal.revealed_index].slashed


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_early_reveal_small_penalty_outside_custody_window(spec, state):
    next_epoch(spec, state)
    epoch = spec.get_current_epoch(state) + spec.RANDAO_PENALTY_EPOCHS
    reveal = get_valid_early_derived_secret_reveal(spec, state, epoch=epoch)
    pre_balance = state.balances[reveal.revealed_index]

    yield from run_early_derived_secret_reveal_processing(spec, state, reveal)

    assert not state.validators[reveal.revealed_index].slashed
    assert state.balances[reveal.revealed_index] < pre_balance
    location = int(epoch % spec.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS)
    assert reveal.revealed_index in state.exposed_derived_secrets[location]


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_early_reveal_too_soon(spec, state):
    next_epoch(spec, state)
    reveal = get_valid_early_derived_secret_reveal(
        spec, state, epoch=spec.get_current_epoch(state)
    )
    yield from run_early_derived_secret_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_early_reveal_too_far_in_future(spec, state):
    next_epoch(spec, state)
    reveal = get_valid_early_derived_secret_reveal(
        spec, state,
        epoch=spec.get_current_epoch(state) + spec.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS,
    )
    yield from run_early_derived_secret_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_early_reveal_double_reveal_rejected(spec, state):
    next_epoch(spec, state)
    epoch = spec.get_current_epoch(state) + spec.RANDAO_PENALTY_EPOCHS
    reveal = get_valid_early_derived_secret_reveal(spec, state, epoch=epoch)
    spec.process_early_derived_secret_reveal(state, reveal)
    yield from run_early_derived_secret_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_early_reveal_already_slashed_rejected(spec, state):
    next_epoch(spec, state)
    reveal = get_valid_early_derived_secret_reveal(spec, state)
    state.validators[reveal.revealed_index].slashed = True
    yield from run_early_derived_secret_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@always_bls
def test_early_reveal_bad_mask_signature(spec, state):
    next_epoch(spec, state)
    reveal = get_valid_early_derived_secret_reveal(spec, state)
    reveal.mask = spec.Bytes32(b'\x77' * 32)  # aggregate no longer covers this mask
    yield from run_early_derived_secret_reveal_processing(spec, state, reveal, valid=False)
