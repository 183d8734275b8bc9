"""Attester-slashing helpers (reference: test/helpers/attester_slashings.py)."""
from .attestations import get_valid_attestation, sign_attestation


def get_valid_attester_slashing(spec, state, slot=None, index=None, signed_1=False, signed_2=False):
    attestation_1 = get_valid_attestation(spec, state, slot=slot, index=index, signed=signed_1)

    attestation_2 = attestation_1.copy()
    attestation_2.data.target.root = b'\x01' * 32

    if signed_2:
        sign_attestation(spec, state, attestation_2)

    return spec.AttesterSlashing(
        attestation_1=spec.get_indexed_attestation(state, attestation_1),
        attestation_2=spec.get_indexed_attestation(state, attestation_2),
    )


def get_indexed_attestation_participants(spec, indexed_att):
    return list(indexed_att.attesting_indices)


def set_indexed_attestation_participants(spec, indexed_att, participants):
    indexed_att.attesting_indices = participants


def get_attestation_1_data(spec, att_slashing):
    return att_slashing.attestation_1.data


def get_attestation_2_data(spec, att_slashing):
    return att_slashing.attestation_2.data


def run_attester_slashing_processing(spec, state, attester_slashing, valid=True):
    """Run ``process_attester_slashing``, yielding (pre, op, post) parts;
    if ``valid == False``, run expecting ``AssertionError``."""
    from ..context import expect_assertion_error
    from .proposer_slashings import get_min_slashing_penalty_quotient

    yield 'pre', state
    yield 'attester_slashing', attester_slashing

    if not valid:
        expect_assertion_error(lambda: spec.process_attester_slashing(state, attester_slashing))
        yield 'post', None
        return

    slashed_indices = set(attester_slashing.attestation_1.attesting_indices).intersection(
        attester_slashing.attestation_2.attesting_indices
    )

    proposer_index = spec.get_beacon_proposer_index(state)
    pre_proposer_balance = state.balances[proposer_index]
    pre_slashing_balances = {i: state.balances[i] for i in slashed_indices}
    pre_slashing_effectives = {i: state.validators[i].effective_balance for i in slashed_indices}
    pre_withdrawable_epochs = {i: state.validators[i].withdrawable_epoch for i in slashed_indices}

    total_proposer_rewards = sum(
        eff_balance // spec.WHISTLEBLOWER_REWARD_QUOTIENT
        for eff_balance in pre_slashing_effectives.values()
    )

    # Process slashing
    spec.process_attester_slashing(state, attester_slashing)

    for slashed_index in slashed_indices:
        slashed_validator = state.validators[slashed_index]
        assert slashed_validator.slashed
        assert slashed_validator.exit_epoch < spec.FAR_FUTURE_EPOCH
        if pre_withdrawable_epochs[slashed_index] < spec.FAR_FUTURE_EPOCH:
            expected_withdrawable_epoch = max(
                pre_withdrawable_epochs[slashed_index],
                spec.get_current_epoch(state) + spec.EPOCHS_PER_SLASHINGS_VECTOR
            )
            assert slashed_validator.withdrawable_epoch == expected_withdrawable_epoch
        else:
            assert slashed_validator.withdrawable_epoch < spec.FAR_FUTURE_EPOCH
        if slashed_index != proposer_index:
            # a slashed validator got slashed
            assert state.balances[slashed_index] < pre_slashing_balances[slashed_index]

    if proposer_index not in slashed_indices:
        # gained whistleblower reward
        assert state.balances[proposer_index] == pre_proposer_balance + total_proposer_rewards
    else:
        # gained rewards for all slashings, which may include the slashing of the proposer,
        # and may be reduced by their own slashing penalty
        expected_balance = (
            pre_proposer_balance
            + total_proposer_rewards
            - pre_slashing_effectives[proposer_index] // get_min_slashing_penalty_quotient(spec)
        )
        assert state.balances[proposer_index] == expected_balance

    yield 'post', state
