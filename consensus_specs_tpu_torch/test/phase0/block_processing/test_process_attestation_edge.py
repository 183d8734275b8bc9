"""process_attestation edge cases — original scenarios extending the base
suite (spec: reference specs/phase0/beacon-chain.md:1804-1831, :719-735;
altair/beacon-chain.md:454-490)."""
from ...context import always_bls, spec_state_test, with_all_phases
from ...helpers.attestations import (
    get_valid_attestation,
    run_attestation_processing,
)
from ...helpers.forks import is_post_altair
from ...helpers.state import next_slot, next_slots


@with_all_phases
@spec_state_test
def test_valid_at_exact_inclusion_delay_edge(spec, state):
    # includable at EXACTLY data.slot + MIN_ATTESTATION_INCLUSION_DELAY
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, int(spec.MIN_ATTESTATION_INCLUSION_DELAY))
    assert state.slot == attestation.data.slot + spec.MIN_ATTESTATION_INCLUSION_DELAY
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
def test_valid_at_exact_expiry_edge(spec, state):
    # includable at EXACTLY data.slot + SLOTS_PER_EPOCH (one slot later is
    # covered by the base suite's test_after_epoch_slots)
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slots(spec, state, int(spec.SLOTS_PER_EPOCH))
    assert state.slot == attestation.data.slot + spec.SLOTS_PER_EPOCH
    yield from run_attestation_processing(spec, state, attestation)


@with_all_phases
@spec_state_test
@always_bls
def test_signature_wrong_domain(spec, state):
    from ...helpers.keys import privkeys

    attestation = get_valid_attestation(spec, state, signed=False)
    participants = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    )
    # sign under the RANDAO domain instead of BEACON_ATTESTER
    domain = spec.get_domain(
        state, spec.DOMAIN_RANDAO, attestation.data.target.epoch
    )
    signing_root = spec.compute_signing_root(attestation.data, domain)
    attestation.signature = spec.bls.Aggregate([
        spec.bls.Sign(privkeys[i], signing_root) for i in participants
    ])
    next_slot(spec, state)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_signature_by_nonparticipants(spec, state):
    from ...helpers.keys import privkeys

    attestation = get_valid_attestation(spec, state, signed=False)
    participants = list(spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ))
    # a correct-domain signature from validators NOT in the bits
    others = [
        i for i in range(len(state.validators)) if i not in participants
    ][: len(participants)]
    domain = spec.get_domain(
        state, spec.DOMAIN_BEACON_ATTESTER, attestation.data.target.epoch
    )
    signing_root = spec.compute_signing_root(attestation.data, domain)
    attestation.signature = spec.bls.Aggregate([
        spec.bls.Sign(privkeys[i], signing_root) for i in others
    ])
    next_slot(spec, state)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_tampered_head_vote_after_signing(spec, state):
    attestation = get_valid_attestation(spec, state, signed=True)
    attestation.data.beacon_block_root = b"\x42" * 32
    next_slot(spec, state)
    yield from run_attestation_processing(spec, state, attestation, valid=False)


@with_all_phases
@spec_state_test
def test_same_attestation_twice_in_state(spec, state):
    # re-processing an identical attestation is VALID; phase0 appends a
    # second PendingAttestation, altair sets no new flags and pays the
    # proposer nothing the second time
    attestation = get_valid_attestation(spec, state, signed=True)
    next_slot(spec, state)
    spec.process_attestation(state, attestation)
    if is_post_altair(spec):
        proposer = spec.get_beacon_proposer_index(state)
        before = int(state.balances[proposer])
        spec.process_attestation(state, attestation)
        assert int(state.balances[proposer]) == before
    else:
        count = len(state.current_epoch_attestations)
        spec.process_attestation(state, attestation)
        assert len(state.current_epoch_attestations) == count + 1


@with_all_phases
@spec_state_test
def test_sparse_single_participant(spec, state):
    # exactly one bit set, signed by that one validator
    def one(participants):
        return {sorted(participants)[0]}

    attestation = get_valid_attestation(
        spec, state, signed=True, filter_participant_set=one
    )
    assert sum(attestation.aggregation_bits) == 1
    next_slot(spec, state)
    yield from run_attestation_processing(spec, state, attestation)
