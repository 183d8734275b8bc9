"""Custody epoch passes: reveal deadlines, challenge deadlines, final
updates (reference specs/custody_game/beacon-chain.md:649-706)."""
from ...context import CUSTODY_GAME, spec_state_test, with_phases
from ...helpers.custody_game import (
    get_attestation_for_blob_header,
    get_sample_custody_data,
    get_shard_blob_header_for_data,
    get_valid_chunk_challenge,
)
from ...helpers.state import next_epoch, next_slot


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_reveal_deadlines_slash_unrevealed(spec, state):
    # jump the clock two custody periods out: every validator still at
    # next_custody_secret_to_reveal=0 has period > deadline(=1)
    state.slot = spec.Slot(
        (2 * int(spec.EPOCHS_PER_CUSTODY_PERIOD) + 2) * int(spec.SLOTS_PER_EPOCH)
    )
    assert not any(v.slashed for v in state.validators)
    spec.process_reveal_deadlines(state)
    assert all(v.slashed for v in state.validators)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_reveal_deadlines_spare_revealed(spec, state):
    state.slot = spec.Slot(
        (2 * int(spec.EPOCHS_PER_CUSTODY_PERIOD) + 2) * int(spec.SLOTS_PER_EPOCH)
    )
    # validator 0 kept up with reveals
    state.validators[0].next_custody_secret_to_reveal = 3
    spec.process_reveal_deadlines(state)
    assert not state.validators[0].slashed
    assert state.validators[1].slashed


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_challenge_deadlines_slash_unresponsive(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)
    data = get_sample_custody_data(spec, samples_count=17)
    header = get_shard_blob_header_for_data(spec, state, data, slot=state.slot - 1, shard=0)
    attestation = get_attestation_for_blob_header(spec, state, header)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header)
    spec.process_chunk_challenge(state, challenge)
    responder = challenge.responder_index

    # stay quiet past the response window
    state.slot = spec.Slot(
        int(state.slot) + (int(spec.EPOCHS_PER_CUSTODY_PERIOD) + 2) * int(spec.SLOTS_PER_EPOCH)
    )
    spec.process_challenge_deadlines(state)

    assert state.validators[responder].slashed
    assert state.custody_chunk_challenge_records[0] == spec.CustodyChunkChallengeRecord()


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_final_updates_restore_withdrawability(spec, state):
    next_epoch(spec, state)
    # an exited validator with all secrets revealed and no open challenges
    # regains a concrete withdrawable epoch
    v = state.validators[0]
    v.exit_epoch = spec.get_current_epoch(state)
    v.withdrawable_epoch = spec.FAR_FUTURE_EPOCH
    v.all_custody_secrets_revealed_epoch = spec.get_current_epoch(state)

    # another exited validator with unrevealed secrets stays locked
    w = state.validators[1]
    w.exit_epoch = spec.get_current_epoch(state)
    w.withdrawable_epoch = spec.Epoch(10)
    w.all_custody_secrets_revealed_epoch = spec.FAR_FUTURE_EPOCH

    spec.process_custody_final_updates(state)

    assert state.validators[0].withdrawable_epoch == (
        state.validators[0].all_custody_secrets_revealed_epoch
        + spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    )
    assert state.validators[1].withdrawable_epoch == spec.FAR_FUTURE_EPOCH


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_final_updates_prune_exposed_secrets(spec, state):
    next_epoch(spec, state)
    location = int(spec.get_current_epoch(state) % spec.EARLY_DERIVED_SECRET_PENALTY_MAX_FUTURE_EPOCHS)
    state.exposed_derived_secrets[location] = [spec.ValidatorIndex(5)]
    spec.process_custody_final_updates(state)
    assert len(state.exposed_derived_secrets[location]) == 0


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_full_epoch_transition_runs_custody_passes(spec, state):
    # a clean multi-epoch run through the custody process_epoch keeps the
    # state consistent and slashes no one
    for _ in range(3):
        next_epoch(spec, state)
    assert not any(v.slashed for v in state.validators)
    assert state.custody_chunk_challenge_index == 0
