"""Custody-game sanity: custody operations through the FULL block
transition (state_transition with the custody process_block pipeline)."""
from ...context import CUSTODY_GAME, spec_state_test, with_phases
from ...helpers.block import build_empty_block_for_next_slot
from ...helpers.custody_game import (
    get_attestation_for_blob_header,
    get_sample_custody_data,
    get_shard_blob_header_for_data,
    get_valid_chunk_challenge,
    get_valid_custody_chunk_response,
    get_valid_early_derived_secret_reveal,
)
from ...helpers.state import next_epoch, next_slot, state_transition_and_sign_block


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_block_with_early_derived_secret_reveal(spec, state):
    next_epoch(spec, state)
    reveal = get_valid_early_derived_secret_reveal(spec, state)

    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.early_derived_secret_reveals = [reveal]
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state

    assert state.validators[reveal.revealed_index].slashed


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_block_with_chunk_challenge_and_response(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)
    data = get_sample_custody_data(spec, samples_count=17)
    header = get_shard_blob_header_for_data(spec, state, data, slot=state.slot - 1, shard=0)
    attestation = get_attestation_for_blob_header(spec, state, header)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=1)

    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.chunk_challenges = [challenge]
    signed_block = state_transition_and_sign_block(spec, state, block)

    record = state.custody_chunk_challenge_records[0]
    assert record.chunk_index == 1

    response = get_valid_custody_chunk_response(spec, state, record, data)
    block2 = build_empty_block_for_next_slot(spec, state)
    block2.body.chunk_challenge_responses = [response]
    signed_block2 = state_transition_and_sign_block(spec, state, block2)
    yield 'blocks', [signed_block, signed_block2]
    yield 'post', state

    assert state.custody_chunk_challenge_records[0] == spec.CustodyChunkChallengeRecord()


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_empty_block_keeps_custody_state(spec, state):
    next_epoch(spec, state)
    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert state.custody_chunk_challenge_index == 0
    assert not any(v.slashed for v in state.validators)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_block_with_custody_key_reveal(spec, state):
    from ...helpers.custody_game import get_valid_custody_key_reveal
    from ...helpers.state import transition_to

    # one custody period must elapse before the first reveal is due; the
    # walk stays short of the deadline epoch so no one gets slashed
    transition_to(
        spec, state,
        state.slot + int(spec.EPOCHS_PER_CUSTODY_PERIOD) * int(spec.SLOTS_PER_EPOCH),
    )
    reveal = get_valid_custody_key_reveal(spec, state)

    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.custody_key_reveals = [reveal]
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state

    assert state.validators[reveal.revealer_index].next_custody_secret_to_reveal == 1
