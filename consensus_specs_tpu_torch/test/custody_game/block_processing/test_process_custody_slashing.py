"""process_custody_slashing tests: the Legendre custody-bit game end to end
(adapted to the executable sharding layer; reference
specs/custody_game/beacon-chain.md:612-668)."""
import pytest

from ...context import (
    CUSTODY_GAME,
    always_bls,
    expect_assertion_error,
    spec_state_test,
    with_phases,
)
from ...helpers.custody_game import (
    find_data_with_custody_bit,
    get_attestation_for_blob_header,
    get_real_custody_secret,
    get_sample_custody_data,
    get_shard_blob_header_for_data,
    get_valid_custody_slashing,
)
from ...helpers.state import next_epoch, next_slot


def run_custody_slashing_processing(spec, state, slashing, valid=True):
    yield 'pre', state
    yield 'custody_slashing', slashing

    if not valid:
        expect_assertion_error(
            lambda: spec.process_custody_slashing(state, slashing)
        )
        yield 'post', None
        return

    spec.process_custody_slashing(state, slashing)
    yield 'post', state


def _setup(spec, state, data):
    next_epoch(spec, state)
    next_slot(spec, state)
    slot = state.slot - 1
    header = get_shard_blob_header_for_data(spec, state, data, slot=slot, shard=0)
    attestation = get_attestation_for_blob_header(spec, state, header)
    return header, attestation


def _malefactor_secret(spec, state, attestation, malefactor_index):
    return get_real_custody_secret(
        spec, state, malefactor_index, attestation.data.target.epoch
    )


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_custody_slashing_false_claim_slashes_whistleblower(spec, state):
    # honest data (custody bit 0): the whistleblower's claim is false
    data = get_sample_custody_data(spec, samples_count=1)
    header, attestation = _setup(spec, state, data)
    attesters = sorted(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ))
    malefactor = attesters[0]
    secret = _malefactor_secret(spec, state, attestation, malefactor)
    assert int(spec.compute_custody_bit(secret, data)) == 0

    slashing = get_valid_custody_slashing(
        spec, state, attestation, header, secret, data, malefactor_index=malefactor
    )
    yield from run_custody_slashing_processing(spec, state, slashing)

    assert state.validators[slashing.message.whistleblower_index].slashed
    assert not state.validators[malefactor].slashed


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_custody_slashing_true_claim_slashes_malefactor(spec, state):
    # search for data whose custody bit is 1 under the malefactor's secret
    # (the reference's slashable-test-vector search)
    probe_data = get_sample_custody_data(spec, samples_count=1)
    header0, attestation0 = _setup(spec, state, probe_data)
    attesters = sorted(spec.get_attesting_indices(
        state, attestation0.data, attestation0.aggregation_bits
    ))
    malefactor = attesters[0]
    secret = _malefactor_secret(spec, state, attestation0, malefactor)
    try:
        data = find_data_with_custody_bit(spec, secret, samples_count=1, want_bit=1)
    except AssertionError:
        pytest.skip("no slashable vector found within the search budget")

    # re-anchor the header + attestation on the slashable data
    slot = state.slot - 1
    header = get_shard_blob_header_for_data(spec, state, data, slot=slot, shard=0)
    attestation = get_attestation_for_blob_header(spec, state, header)

    slashing = get_valid_custody_slashing(
        spec, state, attestation, header, secret, data, malefactor_index=malefactor
    )
    yield from run_custody_slashing_processing(spec, state, slashing)

    assert state.validators[malefactor].slashed


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_custody_slashing_data_length_mismatch(spec, state):
    data = get_sample_custody_data(spec, samples_count=1)
    header, attestation = _setup(spec, state, data)
    attesters = sorted(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ))
    secret = _malefactor_secret(spec, state, attestation, attesters[0])
    slashing = get_valid_custody_slashing(
        spec, state, attestation, header, secret, data, malefactor_index=attesters[0]
    )
    slashing.message.data = data + b'\x00'  # no longer samples_count * BYTES_PER_SAMPLE
    yield from run_custody_slashing_processing(spec, state, slashing, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_custody_slashing_wrong_data_root(spec, state):
    data = get_sample_custody_data(spec, samples_count=1)
    header, attestation = _setup(spec, state, data)
    attesters = sorted(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ))
    secret = _malefactor_secret(spec, state, attestation, attesters[0])
    other = get_sample_custody_data(spec, samples_count=1, seed=99)
    slashing = get_valid_custody_slashing(
        spec, state, attestation, header, secret, other, malefactor_index=attesters[0]
    )
    yield from run_custody_slashing_processing(spec, state, slashing, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
def test_custody_slashing_malefactor_not_attester(spec, state):
    data = get_sample_custody_data(spec, samples_count=1)
    header, attestation = _setup(spec, state, data)
    attesters = spec.get_attesting_indices(state, attestation.data, attestation.aggregation_bits)
    outsider = next(
        i for i in range(len(state.validators)) if spec.ValidatorIndex(i) not in attesters
    )
    secret = _malefactor_secret(spec, state, attestation, outsider)
    slashing = get_valid_custody_slashing(
        spec, state, attestation, header, secret, data,
        malefactor_index=spec.ValidatorIndex(outsider),
    )
    yield from run_custody_slashing_processing(spec, state, slashing, valid=False)


@with_phases([CUSTODY_GAME])
@spec_state_test
@always_bls
def test_custody_slashing_bad_whistleblower_signature(spec, state):
    data = get_sample_custody_data(spec, samples_count=1)
    header, attestation = _setup(spec, state, data)
    attesters = sorted(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ))
    secret = _malefactor_secret(spec, state, attestation, attesters[0])
    slashing = get_valid_custody_slashing(
        spec, state, attestation, header, secret, data,
        malefactor_index=attesters[0], signed=False,
    )
    yield from run_custody_slashing_processing(spec, state, slashing, valid=False)
