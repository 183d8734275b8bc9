"""Chunk challenge + response tests (adapted to the executable sharding
layer — see specsrc/custody_game/beacon_chain.py header; reference
specs/custody_game/beacon-chain.md:379-466)."""
from ...context import (
    CUSTODY_GAME,
    expect_assertion_error,
    spec_state_test,
    with_phases,
)
from ...helpers.custody_game import (
    get_attestation_for_blob_header,
    get_sample_custody_data,
    get_shard_blob_header_for_data,
    get_valid_chunk_challenge,
    get_valid_custody_chunk_response,
)
from ...helpers.state import next_epoch, next_slot


def run_chunk_challenge_processing(spec, state, challenge, valid=True):
    yield 'pre', state
    yield 'chunk_challenge', challenge

    if not valid:
        expect_assertion_error(lambda: spec.process_chunk_challenge(state, challenge))
        yield 'post', None
        return

    pre_index = state.custody_chunk_challenge_index
    spec.process_chunk_challenge(state, challenge)
    assert state.custody_chunk_challenge_index == pre_index + 1
    yield 'post', state


def run_chunk_response_processing(spec, state, response, valid=True):
    yield 'pre', state
    yield 'chunk_challenge_response', response

    if not valid:
        expect_assertion_error(
            lambda: spec.process_chunk_challenge_response(state, response)
        )
        yield 'post', None
        return

    spec.process_chunk_challenge_response(state, response)
    yield 'post', state


def _setup_challengeable_attestation(spec, state, samples_count=17):
    """Blob data spanning 2 custody chunks, its header, and a full-committee
    attestation vouching for it."""
    next_epoch(spec, state)
    next_slot(spec, state)
    slot = state.slot - 1
    data = get_sample_custody_data(spec, samples_count)  # 17 * 248 = 4216 bytes
    header = get_shard_blob_header_for_data(spec, state, data, slot=slot, shard=0)
    attestation = get_attestation_for_blob_header(spec, state, header)
    return data, header, attestation


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_challenge_accepted(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=1)

    yield from run_chunk_challenge_processing(spec, state, challenge)

    record = state.custody_chunk_challenge_records[0]
    assert record.responder_index == challenge.responder_index
    assert record.chunk_index == 1
    assert record.data_root == header.body_summary.data_root
    assert state.validators[challenge.responder_index].withdrawable_epoch == spec.FAR_FUTURE_EPOCH


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_challenge_off_end_chunk_index(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    # 4216 bytes -> 2 chunks; index 2 is past the blob
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=2)
    yield from run_chunk_challenge_processing(spec, state, challenge, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_challenge_wrong_header(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    tampered = header.copy()
    tampered.body_summary.max_fee_per_sample = spec.Gwei(1234)
    challenge = get_valid_chunk_challenge(spec, state, attestation, tampered, chunk_index=0)
    yield from run_chunk_challenge_processing(spec, state, challenge, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_challenge_duplicate_rejected(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=0)
    spec.process_chunk_challenge(state, challenge)
    again = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=0)
    yield from run_chunk_challenge_processing(spec, state, again, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_challenge_second_chunk_after_first(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    spec.process_chunk_challenge(
        state, get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=0)
    )
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=1)
    yield from run_chunk_challenge_processing(spec, state, challenge)
    assert state.custody_chunk_challenge_index == 2


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_challenge_responder_not_attester(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    attesters = spec.get_attesting_indices(state, attestation.data, attestation.aggregation_bits)
    outsider = next(
        i for i in range(len(state.validators)) if spec.ValidatorIndex(i) not in attesters
    )
    challenge = get_valid_chunk_challenge(
        spec, state, attestation, header, chunk_index=0,
        responder_index=spec.ValidatorIndex(outsider),
    )
    yield from run_chunk_challenge_processing(spec, state, challenge, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_response_clears_challenge(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=1)
    spec.process_chunk_challenge(state, challenge)
    record = state.custody_chunk_challenge_records[0]

    proposer_index = spec.get_beacon_proposer_index(state)
    pre_balance = state.balances[proposer_index]
    response = get_valid_custody_chunk_response(spec, state, record, data)

    yield from run_chunk_response_processing(spec, state, response)

    assert state.custody_chunk_challenge_records[0] == spec.CustodyChunkChallengeRecord()
    assert state.balances[proposer_index] > pre_balance


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_response_wrong_chunk_index(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=1)
    spec.process_chunk_challenge(state, challenge)
    response = get_valid_custody_chunk_response(
        spec, state, state.custody_chunk_challenge_records[0], data
    )
    response.chunk_index = 0
    yield from run_chunk_response_processing(spec, state, response, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_response_invalid_proof(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=0)
    spec.process_chunk_challenge(state, challenge)
    response = get_valid_custody_chunk_response(
        spec, state, state.custody_chunk_challenge_records[0], data
    )
    branch = list(response.branch)
    branch[0] = spec.Root(b'\x66' * 32)
    response.branch = branch
    yield from run_chunk_response_processing(spec, state, response, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_chunk_response_unknown_challenge(spec, state):
    data, header, attestation = _setup_challengeable_attestation(spec, state)
    challenge = get_valid_chunk_challenge(spec, state, attestation, header, chunk_index=0)
    spec.process_chunk_challenge(state, challenge)
    response = get_valid_custody_chunk_response(
        spec, state, state.custody_chunk_challenge_records[0], data
    )
    response.challenge_index = 999
    yield from run_chunk_response_processing(spec, state, response, valid=False)
