"""process_custody_key_reveal tests (scenario coverage modeled on the
reference's custody_game/block_processing suite — which cannot run there —
written for this harness; reference
specs/custody_game/beacon-chain.md:517-568)."""
from ...context import (
    CUSTODY_GAME,
    always_bls,
    disable_process_reveal_deadlines,
    expect_assertion_error,
    spec_state_test,
    with_phases,
)
from ...helpers.custody_game import get_valid_custody_key_reveal
from ...helpers.state import transition_to


def run_custody_key_reveal_processing(spec, state, custody_key_reveal, valid=True):
    yield 'pre', state
    yield 'custody_key_reveal', custody_key_reveal

    if not valid:
        expect_assertion_error(
            lambda: spec.process_custody_key_reveal(state, custody_key_reveal)
        )
        yield 'post', None
        return

    revealer_index = custody_key_reveal.revealer_index
    pre_next = state.validators[revealer_index].next_custody_secret_to_reveal
    proposer_index = spec.get_beacon_proposer_index(state)
    pre_proposer_balance = state.balances[proposer_index]

    spec.process_custody_key_reveal(state, custody_key_reveal)

    assert state.validators[revealer_index].next_custody_secret_to_reveal == pre_next + 1
    if proposer_index != revealer_index:
        assert state.balances[proposer_index] > pre_proposer_balance

    yield 'post', state


def _advance_periods(spec, state, periods):
    transition_to(
        spec, state,
        state.slot + periods * int(spec.EPOCHS_PER_CUSTODY_PERIOD) * int(spec.SLOTS_PER_EPOCH),
    )


@with_phases([CUSTODY_GAME])
@spec_state_test
@disable_process_reveal_deadlines
def test_custody_key_reveal_success(spec, state):
    _advance_periods(spec, state, 1)
    reveal = get_valid_custody_key_reveal(spec, state)
    yield from run_custody_key_reveal_processing(spec, state, reveal)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_custody_key_reveal_too_early(spec, state):
    # genesis epoch: the revealer's current period is 0 and nothing is past
    reveal = get_valid_custody_key_reveal(spec, state)
    yield from run_custody_key_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@always_bls
@disable_process_reveal_deadlines
def test_custody_key_reveal_wrong_period(spec, state):
    # signature over a future period's epoch doesn't verify against the
    # validator's next unrevealed period
    _advance_periods(spec, state, 1)
    reveal = get_valid_custody_key_reveal(spec, state, period=5)
    yield from run_custody_key_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@disable_process_reveal_deadlines
def test_custody_key_reveal_double_reveal(spec, state):
    # two periods elapsed: two consecutive reveals pass, a third is early
    _advance_periods(spec, state, 2)
    revealer_index = spec.get_active_validator_indices(
        state, spec.get_current_epoch(state)
    )[0]

    for _ in range(2):
        reveal = get_valid_custody_key_reveal(spec, state, validator_index=revealer_index)
        spec.process_custody_key_reveal(state, reveal)

    reveal = get_valid_custody_key_reveal(spec, state, validator_index=revealer_index)
    yield from run_custody_key_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@disable_process_reveal_deadlines
def test_custody_key_reveal_max_decrement_when_slashed(spec, state):
    # a slashed (non-slashable) validator cannot reveal
    _advance_periods(spec, state, 1)
    reveal = get_valid_custody_key_reveal(spec, state)
    state.validators[reveal.revealer_index].slashed = True
    yield from run_custody_key_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@always_bls
@disable_process_reveal_deadlines
def test_custody_key_reveal_corrupted_signature(spec, state):
    # right period, right revealer — but the reveal itself is not the
    # revealer's BLS signature over the period epoch
    _advance_periods(spec, state, 1)
    reveal = get_valid_custody_key_reveal(spec, state)
    sig = bytearray(bytes(reveal.reveal))
    sig[-1] ^= 0x01
    reveal.reveal = sig
    yield from run_custody_key_reveal_processing(spec, state, reveal, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@disable_process_reveal_deadlines
def test_custody_key_reveal_ghost_revealer(spec, state):
    # a revealer index one past the registry must be refused outright
    _advance_periods(spec, state, 1)
    reveal = get_valid_custody_key_reveal(spec, state)
    reveal.revealer_index = len(state.validators)
    yield from run_custody_key_reveal_processing(spec, state, reveal, valid=False)
