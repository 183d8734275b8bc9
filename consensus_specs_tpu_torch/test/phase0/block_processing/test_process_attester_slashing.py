"""process_attester_slashing handler tests
(reference: test/phase0/block_processing/test_process_attester_slashing.py)."""
from ...context import always_bls, spec_state_test, with_all_phases
from ...helpers.attestations import sign_indexed_attestation
from ...helpers.attester_slashings import (
    get_indexed_attestation_participants, get_valid_attester_slashing,
    run_attester_slashing_processing,
)
from ...helpers.state import next_epoch


@with_all_phases
@spec_state_test
def test_success_double(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)

    yield from run_attester_slashing_processing(spec, state, attester_slashing)


@with_all_phases
@spec_state_test
def test_success_surround(spec, state):
    next_epoch(spec, state)

    state.current_justified_checkpoint.epoch += 1
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)
    att_1 = attester_slashing.attestation_1
    att_2 = attester_slashing.attestation_2

    # set attestation1 to surround attestation 2
    att_1.data.source.epoch = att_2.data.source.epoch - 1
    att_1.data.target.epoch = att_2.data.target.epoch + 1

    sign_indexed_attestation(spec, state, attester_slashing.attestation_1)

    yield from run_attester_slashing_processing(spec, state, attester_slashing)


@with_all_phases
@spec_state_test
@always_bls
def test_success_already_exited_recent(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    slashed_indices = get_indexed_attestation_participants(spec, attester_slashing.attestation_1)
    for index in slashed_indices:
        spec.initiate_validator_exit(state, index)

    yield from run_attester_slashing_processing(spec, state, attester_slashing)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_1(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)
    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_2(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=False)
    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_1_and_2(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=False)
    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
def test_same_data(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)

    indexed_att_1 = attester_slashing.attestation_1
    att_2_data = attester_slashing.attestation_2.data
    indexed_att_1.data = att_2_data
    sign_indexed_attestation(spec, state, attester_slashing.attestation_1)

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
def test_no_double_or_surround(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)

    attester_slashing.attestation_1.data.target.epoch += 1
    sign_indexed_attestation(spec, state, attester_slashing.attestation_1)

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
def test_participants_already_slashed(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)

    # set all indices to slashed
    validator_indices = get_indexed_attestation_participants(spec, attester_slashing.attestation_1)
    for index in validator_indices:
        state.validators[index].slashed = True

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_att1_high_index(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)

    indices = get_indexed_attestation_participants(spec, attester_slashing.attestation_1)
    indices.append(spec.ValidatorIndex(len(state.validators)))  # off by 1
    attester_slashing.attestation_1.attesting_indices = indices

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_att1_empty_indices(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)

    attester_slashing.attestation_1.attesting_indices = []
    attester_slashing.attestation_1.signature = spec.bls.G2_POINT_AT_INFINITY

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_all_empty_indices(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=False)

    attester_slashing.attestation_1.attesting_indices = []
    attester_slashing.attestation_1.signature = spec.bls.G2_POINT_AT_INFINITY

    attester_slashing.attestation_2.attesting_indices = []
    attester_slashing.attestation_2.signature = spec.bls.G2_POINT_AT_INFINITY

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_unsorted_att_1(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)

    indices = get_indexed_attestation_participants(spec, attester_slashing.attestation_1)
    assert len(indices) >= 3
    indices[1], indices[2] = indices[2], indices[1]  # unsort second and third index
    attester_slashing.attestation_1.attesting_indices = indices
    sign_indexed_attestation(spec, state, attester_slashing.attestation_1)

    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


def _mutate_indices(spec, state, attester_slashing, which, mutate, resign=True):
    """Apply ``mutate`` to attestation_{which}'s attesting_indices; re-sign
    unless testing the stale-signature path."""
    att = (attester_slashing.attestation_1 if which == 1
           else attester_slashing.attestation_2)
    indices = list(att.attesting_indices)
    att.attesting_indices = mutate(indices)
    if resign:
        sign_indexed_attestation(spec, state, att)
    return attester_slashing


@with_all_phases
@spec_state_test
def test_att2_high_index(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 2,
                        lambda ix: ix + [len(state.validators)], resign=False),
        valid=False,
    )


@with_all_phases
@spec_state_test
def test_att2_empty_indices(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=False)
    attester_slashing.attestation_2.attesting_indices = []
    yield from run_attester_slashing_processing(spec, state, attester_slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_att1_bad_extra_index(spec, state):
    # an index smuggled in WITHOUT re-signing: aggregate no longer matches
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    participants = get_indexed_attestation_participants(spec, attester_slashing.attestation_1)
    outsider = next(
        i for i in range(len(state.validators)) if i not in participants
    )
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 1,
                        lambda ix: sorted(ix + [outsider]), resign=False),
        valid=False,
    )


@with_all_phases
@spec_state_test
@always_bls
def test_att1_bad_replaced_index(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    participants = get_indexed_attestation_participants(spec, attester_slashing.attestation_1)
    outsider = next(
        i for i in range(len(state.validators)) if i not in participants
    )
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 1,
                        lambda ix: sorted([outsider] + ix[1:]), resign=False),
        valid=False,
    )


@with_all_phases
@spec_state_test
@always_bls
def test_att2_bad_extra_index(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    participants = get_indexed_attestation_participants(spec, attester_slashing.attestation_2)
    outsider = next(
        i for i in range(len(state.validators)) if i not in participants
    )
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 2,
                        lambda ix: sorted(ix + [outsider]), resign=False),
        valid=False,
    )


@with_all_phases
@spec_state_test
@always_bls
def test_att2_bad_replaced_index(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    participants = get_indexed_attestation_participants(spec, attester_slashing.attestation_2)
    outsider = next(
        i for i in range(len(state.validators)) if i not in participants
    )
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 2,
                        lambda ix: sorted([outsider] + ix[1:]), resign=False),
        valid=False,
    )


@with_all_phases
@spec_state_test
def test_att1_duplicate_index_normal_signed(spec, state):
    # a duplicated index breaks the sorted-and-unique requirement even when
    # the signature is re-computed over the padded list
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 1,
                        lambda ix: sorted(ix + [ix[0]])),
        valid=False,
    )


@with_all_phases
@spec_state_test
def test_att2_duplicate_index_normal_signed(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 2,
                        lambda ix: sorted(ix + [ix[0]])),
        valid=False,
    )


@with_all_phases
@spec_state_test
def test_unsorted_att_2(spec, state):
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_attester_slashing_processing(
        spec, state,
        _mutate_indices(spec, state, attester_slashing, 2,
                        lambda ix: list(reversed(ix))),
        valid=False,
    )


@with_all_phases
@spec_state_test
def test_success_attestations_from_future(spec, state):
    # slashable data with epochs ahead of the state clock is still slashable
    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=False)
    attester_slashing.attestation_1.data.target.epoch += 10
    attester_slashing.attestation_2.data.target.epoch += 10
    attester_slashing.attestation_1.data.source.epoch += 2
    sign_indexed_attestation(spec, state, attester_slashing.attestation_1)
    sign_indexed_attestation(spec, state, attester_slashing.attestation_2)
    # double vote at the (future) target epoch
    assert spec.is_slashable_attestation_data(
        attester_slashing.attestation_1.data, attester_slashing.attestation_2.data
    )
    yield from run_attester_slashing_processing(spec, state, attester_slashing)


# -- the reference-named variants that were still
#    missing (duplicate-index double-signing, balance-profile states,
#    slashed-proposer reporting, stale/future attestation shapes) ----------

from ...context import (
    low_balances, misc_balances, spec_test, with_custom_state,
)
from ...helpers.attester_slashings import set_indexed_attestation_participants


@with_all_phases
@spec_state_test
@always_bls
def test_att1_duplicate_index_double_signed(spec, state):
    # a doubled index inside attestation_1's index list: indices are not
    # sorted-and-unique -> is_valid_indexed_attestation fails the slashing
    slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=True)
    indices = list(slashing.attestation_1.attesting_indices)
    indices.insert(1, indices[1])  # duplicate one participant
    set_indexed_attestation_participants(spec, slashing.attestation_1, indices)
    sign_indexed_attestation(spec, state, slashing.attestation_1)
    yield from run_attester_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_att2_duplicate_index_double_signed(spec, state):
    slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=False)
    indices = list(slashing.attestation_2.attesting_indices)
    indices.insert(2, indices[2])
    set_indexed_attestation_participants(spec, slashing.attestation_2, indices)
    sign_indexed_attestation(spec, state, slashing.attestation_2)
    yield from run_attester_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_test
@with_custom_state(balances_fn=low_balances, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_success_low_balances(spec, state):
    slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_attester_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_test
@with_custom_state(balances_fn=misc_balances, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_success_misc_balances(spec, state):
    slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_attester_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
def test_success_proposer_index_slashed(spec, state):
    # the reporting proposer is ALREADY slashed: whistleblower rewards
    # still flow to it (slash_validator pays the current proposer
    # unconditionally, reference specs/phase0/beacon-chain.md:1140-1165)
    proposer = spec.get_beacon_proposer_index(state)
    spec.slash_validator(state, proposer)
    slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    participants = get_indexed_attestation_participants(spec, slashing.attestation_1)
    if proposer in participants:
        import pytest

        pytest.skip("proposer happens to be in the slashable committee")
    yield from run_attester_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
def test_success_already_exited_long_ago(spec, state):
    # the offender initiated an exit long before the slashing lands; it is
    # still slashable until withdrawable_epoch passes
    slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    victim = get_indexed_attestation_participants(spec, slashing.attestation_1)[0]
    spec.initiate_validator_exit(state, victim)
    state.validators[victim].withdrawable_epoch = (
        spec.get_current_epoch(state) + 4
    )
    yield from run_attester_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
@always_bls
def test_success_attestation_from_future(spec, state):
    # slashable votes whose attested slot is ahead of the state's clock:
    # process_attester_slashing has no slot-bound checks, only slashability
    next_epoch(spec, state)
    slashing = get_valid_attester_slashing(
        spec, state, slot=state.slot - 1, signed_1=False, signed_2=False
    )
    for att in (slashing.attestation_1, slashing.attestation_2):
        att.data.slot = state.slot + 10  # ahead of the clock
    sign_indexed_attestation(spec, state, slashing.attestation_1)
    sign_indexed_attestation(spec, state, slashing.attestation_2)
    yield from run_attester_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
def test_success_with_effective_balance_disparity(spec, state):
    # wildly uneven effective balances among the slashed set: penalties are
    # per-validator proportional, audited by the runner
    slashing = get_valid_attester_slashing(spec, state, signed_1=False, signed_2=False)
    participants = get_indexed_attestation_participants(spec, slashing.attestation_1)
    inc = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    for j, v in enumerate(participants):
        state.validators[v].effective_balance = spec.Gwei(
            inc * (1 + (j * 7) % 32)
        )
        state.balances[v] = spec.Gwei(inc * (1 + (j * 7) % 32))
    sign_indexed_attestation(spec, state, slashing.attestation_1)
    sign_indexed_attestation(spec, state, slashing.attestation_2)
    yield from run_attester_slashing_processing(spec, state, slashing)
