"""Sanity block-transition tests (reference: test/phase0/sanity/test_blocks.py).

Provenance: adapted from the reference's test/phase0/sanity/test_blocks.py — scenario code and comments largely follow the reference test suite; newer suites in this repo are original.
"""
from ...context import (
    always_bls, expect_assertion_error, spec_state_test, with_all_phases,
)
from ...helpers.attestations import get_valid_attestation
from ...helpers.attester_slashings import get_valid_attester_slashing
from ...helpers.forks import is_post_altair
from ...helpers.sync_committee import compute_sync_committee_participant_reward_and_penalty
from ...helpers.block import (
    build_empty_block, build_empty_block_for_next_slot, sign_block,
    transition_unsigned_block,
)
from ...helpers.deposits import prepare_state_and_deposit
from ...helpers.keys import pubkeys
from ...helpers.proposer_slashings import get_valid_proposer_slashing
from ...helpers.state import (
    next_epoch,
    next_slot,
    state_transition_and_sign_block,
)
from ...helpers.voluntary_exits import prepare_signed_exits


@with_all_phases
@spec_state_test
def test_prev_slot_block_transition(spec, state):
    # Go to clean slot
    spec.process_slots(state, state.slot + 1)
    # Make a block for it
    block = build_empty_block(spec, state, slot=state.slot)
    proposer_index = spec.get_beacon_proposer_index(state)
    # Transition to next slot, above block slot
    spec.process_slots(state, state.slot + 1)

    yield 'pre', state
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    block.state_root = state.latest_block_header.state_root
    signed_block = sign_block(spec, state, block, proposer_index=proposer_index)
    yield 'blocks', [signed_block]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_same_slot_block_transition(spec, state):
    # Same slot on top of pre-state, but move out of slot 0 first.
    spec.process_slots(state, state.slot + 1)
    block = build_empty_block(spec, state, slot=state.slot)

    yield 'pre', state

    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state


@with_all_phases
@spec_state_test
def test_empty_block_transition(spec, state):
    pre_slot = state.slot
    pre_eth1_votes = len(state.eth1_data_votes)
    pre_mix = spec.get_randao_mix(state, spec.get_current_epoch(state))

    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    assert len(state.eth1_data_votes) == pre_eth1_votes + 1
    assert spec.get_block_root_at_slot(state, pre_slot) == block.parent_root
    assert spec.get_randao_mix(state, spec.get_current_epoch(state)) != pre_mix


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_block_sig(spec, state):
    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    invalid_signed_block = spec.SignedBeaconBlock(message=block)
    expect_assertion_error(
        lambda: spec.state_transition(state, invalid_signed_block)
    )

    yield 'blocks', [invalid_signed_block]
    yield 'post', None


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_proposer_index_sig_from_expected_proposer(spec, state):
    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    expect_proposer_index = block.proposer_index

    # Set invalid proposer index but correct signature by expected proposer
    active_indices = spec.get_active_validator_indices(state, spec.get_current_epoch(state))
    active_indices = [i for i in active_indices if i != block.proposer_index]
    block.proposer_index = active_indices[0]  # invalid proposer index

    invalid_signed_block = sign_block(spec, state, block, expect_proposer_index)

    expect_assertion_error(
        lambda: spec.state_transition(state, invalid_signed_block)
    )

    yield 'blocks', [invalid_signed_block]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_skipped_slots(spec, state):
    pre_slot = state.slot
    yield 'pre', state

    block = build_empty_block(spec, state, state.slot + 4)
    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    assert state.slot == block.slot
    assert spec.get_randao_mix(state, spec.get_current_epoch(state)) != spec.Bytes32()
    for slot in range(pre_slot, state.slot):
        assert spec.get_block_root_at_slot(state, slot) == block.parent_root


@with_all_phases
@spec_state_test
def test_empty_epoch_transition(spec, state):
    pre_slot = state.slot
    yield 'pre', state

    block = build_empty_block(spec, state, state.slot + spec.SLOTS_PER_EPOCH)
    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    assert state.slot == block.slot
    for slot in range(pre_slot, state.slot):
        assert spec.get_block_root_at_slot(state, slot) == block.parent_root


@with_all_phases
@spec_state_test
def test_proposer_slashing(spec, state):
    # copy for later balance lookups.
    pre_state = state.copy()
    proposer_slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    slashed_index = proposer_slashing.signed_header_1.message.proposer_index

    assert not state.validators[slashed_index].slashed

    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    block.body.proposer_slashings.append(proposer_slashing)
    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    # check if slashed
    slashed_validator = state.validators[slashed_index]
    assert slashed_validator.slashed
    assert slashed_validator.exit_epoch < spec.FAR_FUTURE_EPOCH
    assert slashed_validator.withdrawable_epoch < spec.FAR_FUTURE_EPOCH

    # lost whistleblower reward
    assert state.balances[slashed_index] < pre_state.balances[slashed_index]


@with_all_phases
@spec_state_test
def test_attester_slashing(spec, state):
    # copy for later balance lookups.
    pre_state = state.copy()

    attester_slashing = get_valid_attester_slashing(spec, state, signed_1=True, signed_2=True)
    validator_index = attester_slashing.attestation_1.attesting_indices[0]

    assert not state.validators[validator_index].slashed

    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    block.body.attester_slashings.append(attester_slashing)
    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    slashed_validator = state.validators[validator_index]
    assert slashed_validator.slashed
    assert slashed_validator.exit_epoch < spec.FAR_FUTURE_EPOCH
    assert slashed_validator.withdrawable_epoch < spec.FAR_FUTURE_EPOCH

    # lost whistleblower reward
    assert state.balances[validator_index] < pre_state.balances[validator_index]

    proposer_index = spec.get_beacon_proposer_index(state)
    # gained whistleblower reward
    assert state.balances[proposer_index] > pre_state.balances[proposer_index]


@with_all_phases
@spec_state_test
def test_deposit_in_block(spec, state):
    initial_registry_len = len(state.validators)
    initial_balances_len = len(state.balances)

    validator_index = len(state.validators)
    amount = spec.MAX_EFFECTIVE_BALANCE
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount, signed=True)

    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    block.body.deposits.append(deposit)

    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    assert len(state.validators) == initial_registry_len + 1
    assert len(state.balances) == initial_balances_len + 1
    assert state.balances[validator_index] == spec.MAX_EFFECTIVE_BALANCE
    assert state.validators[validator_index].pubkey == pubkeys[validator_index]


@with_all_phases
@spec_state_test
def test_deposit_top_up(spec, state):
    validator_index = 0
    amount = spec.MAX_EFFECTIVE_BALANCE // 4
    deposit = prepare_state_and_deposit(spec, state, validator_index, amount)

    initial_registry_len = len(state.validators)
    initial_balances_len = len(state.balances)
    validator_pre_balance = state.balances[validator_index]

    yield 'pre', state

    block = build_empty_block_for_next_slot(spec, state)
    block.body.deposits.append(deposit)

    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    assert len(state.validators) == initial_registry_len
    assert len(state.balances) == initial_balances_len
    if not is_post_altair(spec):
        assert state.balances[validator_index] == validator_pre_balance + amount
    else:
        # altair+: the block's (empty-participation) sync aggregate also
        # penalizes any sync-committee seats this validator holds, so account
        # for those before comparing
        seats = [
            pk for pk in state.current_sync_committee.pubkeys
            if pk == state.validators[validator_index].pubkey
        ]
        participant_reward, _ = compute_sync_committee_participant_reward_and_penalty(spec, state)
        expected = validator_pre_balance + amount - len(seats) * participant_reward
        assert state.balances[validator_index] == expected


@with_all_phases
@spec_state_test
def test_attestation(spec, state):
    next_epoch(spec, state)

    yield 'pre', state

    attestation_block = build_empty_block(spec, state, state.slot + spec.MIN_ATTESTATION_INCLUSION_DELAY)

    index = 0
    attestation = get_valid_attestation(spec, state, index=index, signed=True)

    # Add to state via block transition
    if not is_post_altair(spec):
        pre_current_attestations_len = len(state.current_epoch_attestations)
    attestation_block.body.attestations.append(attestation)
    signed_attestation_block = state_transition_and_sign_block(spec, state, attestation_block)

    if not is_post_altair(spec):
        assert len(state.current_epoch_attestations) == pre_current_attestations_len + 1
        # Epoch transition should move to previous_epoch_attestations
        pre_current_attestations_root = spec.hash_tree_root(state.current_epoch_attestations)
    else:
        # altair+: the accounting lives in the participation-flag arrays
        assert state.current_epoch_participation != [spec.ParticipationFlags(0)] * len(state.validators)
        pre_current_participation_root = spec.hash_tree_root(state.current_epoch_participation)

    epoch_block = build_empty_block(spec, state, state.slot + spec.SLOTS_PER_EPOCH)
    signed_epoch_block = state_transition_and_sign_block(spec, state, epoch_block)

    yield 'blocks', [signed_attestation_block, signed_epoch_block]
    yield 'post', state

    if not is_post_altair(spec):
        assert len(state.current_epoch_attestations) == 0
        assert spec.hash_tree_root(state.previous_epoch_attestations) == pre_current_attestations_root
    else:
        # participation flags rotate current -> previous at the epoch boundary
        assert state.current_epoch_participation == [spec.ParticipationFlags(0)] * len(state.validators)
        assert spec.hash_tree_root(state.previous_epoch_participation) == pre_current_participation_root


@with_all_phases
@spec_state_test
def test_voluntary_exit(spec, state):
    validator_index = spec.get_active_validator_indices(state, spec.get_current_epoch(state))[-1]

    # move state forward SHARD_COMMITTEE_PERIOD epochs to allow for exit
    state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH

    yield 'pre', state

    signed_exits = prepare_signed_exits(spec, state, [validator_index])

    # Add to state via block transition
    initiate_exit_block = build_empty_block_for_next_slot(spec, state)
    initiate_exit_block.body.voluntary_exits = signed_exits
    signed_initiate_exit_block = state_transition_and_sign_block(spec, state, initiate_exit_block)

    assert state.validators[validator_index].exit_epoch < spec.FAR_FUTURE_EPOCH

    # Process within epoch transition
    exit_block = build_empty_block(spec, state, state.slot + spec.SLOTS_PER_EPOCH)
    signed_exit_block = state_transition_and_sign_block(spec, state, exit_block)

    yield 'blocks', [signed_initiate_exit_block, signed_exit_block]
    yield 'post', state

    assert state.validators[validator_index].exit_epoch < spec.FAR_FUTURE_EPOCH


@with_all_phases
@spec_state_test
def test_balance_driven_status_transitions(spec, state):
    current_epoch = spec.get_current_epoch(state)
    validator_index = spec.get_active_validator_indices(state, current_epoch)[-1]

    assert state.validators[validator_index].exit_epoch == spec.FAR_FUTURE_EPOCH

    # set validator balance to below ejection threshold
    state.validators[validator_index].effective_balance = spec.config.EJECTION_BALANCE

    yield 'pre', state

    # trigger epoch transition
    block = build_empty_block(spec, state, state.slot + spec.SLOTS_PER_EPOCH)
    signed_block = state_transition_and_sign_block(spec, state, block)

    yield 'blocks', [signed_block]
    yield 'post', state

    assert state.validators[validator_index].exit_epoch < spec.FAR_FUTURE_EPOCH


@with_all_phases
@spec_state_test
def test_eth1_data_votes_consensus(spec, state):
    # Don't run when the voting period is longer than an epoch in slots
    voting_period_slots = spec.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.SLOTS_PER_EPOCH

    offset_block = build_empty_block(spec, state, voting_period_slots - 1)
    state_transition_and_sign_block(spec, state, offset_block)
    yield 'pre', state

    a = b'\xaa' * 32
    b = b'\xbb' * 32
    c = b'\xcc' * 32

    blocks = []

    for i in range(0, voting_period_slots):
        block = build_empty_block_for_next_slot(spec, state)
        # wait for over 50% for A, then start voting B
        block.body.eth1_data.block_hash = b if i * 2 > voting_period_slots else a
        signed_block = state_transition_and_sign_block(spec, state, block)
        blocks.append(signed_block)

    assert len(state.eth1_data_votes) == voting_period_slots
    assert state.eth1_data.block_hash == a

    # transition to next eth1 voting period
    block = build_empty_block_for_next_slot(spec, state)
    block.body.eth1_data.block_hash = c
    signed_block = state_transition_and_sign_block(spec, state, block)
    blocks.append(signed_block)

    yield 'blocks', blocks
    yield 'post', state

    assert state.eth1_data.block_hash == a
    assert state.slot % voting_period_slots == 0
    assert len(state.eth1_data_votes) == 1
    assert state.eth1_data_votes[0].block_hash == c


@with_all_phases
@spec_state_test
def test_full_operation_mix_in_one_block(spec, state):
    """One block carrying an attestation, a proposer slashing, an attester
    slashing, a deposit top-up, and a voluntary exit simultaneously — the
    operation kinds must compose (process_operations order,
    reference specs/phase0/beacon-chain.md:1742-1756)."""
    # age the chain so exits are permitted and attestations exist
    state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH
    next_epoch(spec, state)

    deposit = prepare_state_and_deposit(
        spec, state, validator_index=1, amount=spec.MAX_EFFECTIVE_BALANCE // 4,
        signed=True,
    )

    block = build_empty_block_for_next_slot(spec, state)
    attestation = get_valid_attestation(spec, state, slot=state.slot, signed=True)
    proposer_slashing = get_valid_proposer_slashing(
        spec, state, signed_1=True, signed_2=True
    )
    ps_index = proposer_slashing.signed_header_1.message.proposer_index
    attester_slashing = get_valid_attester_slashing(
        spec, state, signed_1=True, signed_2=True
    )
    as_index = attester_slashing.attestation_1.attesting_indices[0]
    # pick an exit candidate not colliding with the slashed validators
    exit_index = next(
        i for i in spec.get_active_validator_indices(state, spec.get_current_epoch(state))
        if i not in (ps_index, as_index, 1)
    )
    signed_exits = prepare_signed_exits(spec, state, [exit_index])

    block.body.attestations.append(attestation)
    block.body.proposer_slashings.append(proposer_slashing)
    block.body.attester_slashings.append(attester_slashing)
    block.body.deposits.append(deposit)
    block.body.voluntary_exits = signed_exits
    block.body.eth1_data.deposit_count = state.eth1_deposit_index + 1

    yield 'pre', state
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state

    assert state.validators[ps_index].slashed
    assert state.validators[as_index].slashed
    assert state.validators[exit_index].exit_epoch < spec.FAR_FUTURE_EPOCH


@with_all_phases
@spec_state_test
def test_skipped_slots_then_block(spec, state):
    # several empty slots, then a block: ancestry roots must all point at
    # the last actual block
    yield 'pre', state
    block = build_empty_block(spec, state, slot=state.slot + 4)
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert state.slot == block.slot
    pre_root = block.parent_root
    for slot in range(int(block.slot) - 4, int(block.slot)):
        assert spec.get_block_root_at_slot(state, slot) == pre_root


@with_all_phases
@spec_state_test
def test_empty_epoch_then_block(spec, state):
    # a whole empty epoch before the next block
    yield 'pre', state
    block = build_empty_block(
        spec, state, slot=state.slot + int(spec.SLOTS_PER_EPOCH) + 1
    )
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert spec.get_current_epoch(state) == 1


@with_all_phases
@spec_state_test
def test_proposer_index_mismatch_rejected(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    active = spec.get_active_validator_indices(state, spec.get_current_epoch(state))
    block.proposer_index = next(
        i for i in active if i != block.proposer_index
    )
    yield 'pre', state
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    yield 'blocks', [spec.SignedBeaconBlock(message=block)]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_wrong_parent_root_rejected(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    block.parent_root = b'\x58' * 32
    yield 'pre', state
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    yield 'blocks', [spec.SignedBeaconBlock(message=block)]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_wrong_state_root_rejected(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    block.state_root = b'\x44' * 32
    signed_block = sign_block(spec, state, block)
    yield 'pre', state
    expect_assertion_error(
        lambda: spec.state_transition(state, signed_block, True)
    )
    yield 'blocks', [signed_block]
    yield 'post', None


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_block_signature_rejected(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    tmp = state.copy()
    spec.process_slots(tmp, block.slot)
    spec.process_block(tmp, block)
    block.state_root = spec.hash_tree_root(tmp)
    signed_block = spec.SignedBeaconBlock(
        message=block, signature=spec.BLSSignature(b'\x0c' * 96)
    )
    yield 'pre', state
    expect_assertion_error(
        lambda: spec.state_transition(state, signed_block, True)
    )
    yield 'blocks', [signed_block]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_double_same_proposer_slashings_rejected(spec, state):
    # the same slashing twice in one block: second must fail (proposer
    # already slashed)
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    block = build_empty_block_for_next_slot(spec, state)
    block.body.proposer_slashings = [slashing, slashing]
    yield 'pre', state
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    yield 'blocks', [spec.SignedBeaconBlock(message=block)]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_duplicate_attestation_in_block_allowed(spec, state):
    # the same attestation included twice is wasteful but legal
    next_epoch(spec, state)
    next_slot(spec, state)
    attestation = get_valid_attestation(spec, state, slot=state.slot - 1, signed=True)
    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.attestations = [attestation, attestation]
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state


@with_all_phases
@spec_state_test
def test_exit_then_slash_in_sequence(spec, state):
    # exit a validator via block N, slash it via block N+1 — both must land
    state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH
    next_epoch(spec, state)
    target = len(state.validators) - 2
    exits = prepare_signed_exits(spec, state, [target])

    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.voluntary_exits = exits
    signed_block_1 = state_transition_and_sign_block(spec, state, block)
    assert state.validators[target].exit_epoch < spec.FAR_FUTURE_EPOCH

    slashing = get_valid_attester_slashing(
        spec, state, slot=state.slot - 1, signed_1=True, signed_2=True,
    )
    slashed_any = slashing.attestation_1.attesting_indices
    block2 = build_empty_block_for_next_slot(spec, state)
    block2.body.attester_slashings = [slashing]
    signed_block_2 = state_transition_and_sign_block(spec, state, block2)
    yield 'blocks', [signed_block_1, signed_block_2]
    yield 'post', state
    assert any(state.validators[i].slashed for i in slashed_any)


@with_all_phases
@spec_state_test
def test_multiple_attester_slashings_in_block(spec, state):
    # distinct slashable pairs against distinct committees in one block
    next_epoch(spec, state)
    next_slot(spec, state)
    s1 = get_valid_attester_slashing(
        spec, state, slot=state.slot - 1, index=0, signed_1=True, signed_2=True
    )
    s2 = get_valid_attester_slashing(
        spec, state, slot=state.slot - 1, index=1, signed_1=True, signed_2=True
    )
    set_1 = set(s1.attestation_1.attesting_indices)
    set_2 = set(s2.attestation_1.attesting_indices)
    if set_1 & set_2:
        import pytest
        pytest.skip("committees overlap in this configuration")

    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.attester_slashings = [s1, s2]
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert any(state.validators[i].slashed for i in set_1)
    assert any(state.validators[i].slashed for i in set_2)


@with_all_phases
@spec_state_test
def test_proposer_slashing_and_exit_same_block(spec, state):
    state.slot += spec.config.SHARD_COMMITTEE_PERIOD * spec.SLOTS_PER_EPOCH
    next_epoch(spec, state)
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    slashed = slashing.signed_header_1.message.proposer_index
    exit_target = next(
        i for i in range(len(state.validators) - 1, -1, -1) if i != slashed
    )
    exits = prepare_signed_exits(spec, state, [exit_target])

    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.proposer_slashings = [slashing]
    block.body.voluntary_exits = exits
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert state.validators[slashed].slashed
    assert state.validators[exit_target].exit_epoch < spec.FAR_FUTURE_EPOCH


@with_all_phases
@spec_state_test
def test_expected_deposit_count_enforced(spec, state):
    # state says a deposit is due but the block carries none
    state.eth1_data.deposit_count = state.eth1_deposit_index + 1
    block = build_empty_block_for_next_slot(spec, state)
    yield 'pre', state
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    yield 'blocks', [spec.SignedBeaconBlock(message=block)]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_eth1_data_votes_no_consensus(spec, state):
    # a full voting period with the vote split exactly 50/50: neither hash
    # crosses the strict-majority bar, so eth1_data must NOT change
    voting_period_slots = int(
        spec.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.SLOTS_PER_EPOCH
    )
    pre_eth1 = state.eth1_data.block_hash
    offset_block = build_empty_block(spec, state, voting_period_slots - 1)
    state_transition_and_sign_block(spec, state, offset_block)
    yield 'pre', state

    a, b = b'\xaa' * 32, b'\xbb' * 32
    blocks = []
    for i in range(voting_period_slots):
        block = build_empty_block_for_next_slot(spec, state)
        block.body.eth1_data.block_hash = a if i % 2 == 0 else b
        blocks.append(state_transition_and_sign_block(spec, state, block))

    assert state.eth1_data.block_hash == pre_eth1
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_double_validator_exit_same_block_rejected(spec, state):
    # two exits for the SAME validator in one block: the second must hit
    # the "is active and not yet exiting" assert
    next_epoch(spec, state)
    next_epoch(spec, state)
    next_epoch(spec, state)
    next_epoch(spec, state)
    next_epoch(spec, state)  # past SHARD_COMMITTEE_PERIOD
    exits = prepare_signed_exits(spec, state, [5])
    block = build_empty_block_for_next_slot(spec, state)
    block.body.voluntary_exits = exits + exits  # duplicate
    yield 'pre', state
    signed = sign_block(spec, state, block)
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    yield 'blocks', [signed]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_duplicate_attester_slashing_same_block_rejected(spec, state):
    # the same attester slashing twice: the second finds every index
    # already slashed, so "some new validator slashed" fails
    next_epoch(spec, state)
    slashing = get_valid_attester_slashing(
        spec, state, signed_1=True, signed_2=True
    )
    block = build_empty_block_for_next_slot(spec, state)
    block.body.attester_slashings = [slashing, slashing]
    yield 'pre', state
    signed = sign_block(spec, state, block)
    expect_assertion_error(
        lambda: transition_unsigned_block(spec, state, block)
    )
    yield 'blocks', [signed]
    yield 'post', None


@with_all_phases
@spec_state_test
def test_historical_root_batch_crossed(spec, state):
    # advance across a SLOTS_PER_HISTORICAL_ROOT boundary with real blocks
    # at the edges: the accumulator must append exactly one HistoricalBatch
    pre_len = len(state.historical_roots)
    period = int(spec.SLOTS_PER_HISTORICAL_ROOT)
    target = (int(state.slot) // period + 1) * period
    yield 'pre', state
    blocks = []
    # one real block now, empty slots to just before the boundary epoch end,
    # one real block after the crossing
    block = build_empty_block_for_next_slot(spec, state)
    blocks.append(state_transition_and_sign_block(spec, state, block))
    from ...helpers.state import transition_to

    transition_to(spec, state, target + 1)
    block = build_empty_block_for_next_slot(spec, state)
    blocks.append(state_transition_and_sign_block(spec, state, block))
    assert len(state.historical_roots) == pre_len + 1
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_empty_epoch_transition_not_finalizing(spec, state):
    # a whole epoch of empty slots: justification cannot advance, and
    # every eligible validator loses balance at the boundary (no leak yet)
    next_epoch(spec, state)  # move off genesis accounting
    pre_finalized = state.finalized_checkpoint.epoch
    yield 'pre', state
    block = build_empty_block(
        spec, state, state.slot + int(spec.SLOTS_PER_EPOCH) + 1
    )
    signed = state_transition_and_sign_block(spec, state, block)
    assert state.finalized_checkpoint.epoch == pre_finalized
    yield 'blocks', [signed]
    yield 'post', state


@with_all_phases
@spec_state_test
def test_deposit_top_up_exiting_validator(spec, state):
    # a top-up deposit for a validator already past its exit epoch still
    # credits the balance (deposits are unconditional balance credits)
    index = 7
    next_epoch(spec, state)
    v = state.validators[index]
    v.exit_epoch = spec.get_current_epoch(state)
    v.withdrawable_epoch = v.exit_epoch + spec.config.MIN_VALIDATOR_WITHDRAWABILITY_DELAY
    amount = spec.EFFECTIVE_BALANCE_INCREMENT
    # control: the same empty block WITHOUT the deposit (isolates the
    # credit from per-block effects like altair's sync-committee penalty);
    # copied BEFORE prepare so the expected-deposit-count gate stays zero
    control = state.copy()
    control_block = build_empty_block_for_next_slot(spec, control)
    transition_unsigned_block(spec, control, control_block)
    deposit = prepare_state_and_deposit(spec, state, index, amount, signed=True)
    pre_balance = int(state.balances[index])
    control_delta = int(control.balances[index]) - pre_balance
    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.deposits = [deposit]
    signed = state_transition_and_sign_block(spec, state, block)
    assert int(state.balances[index]) == pre_balance + control_delta + int(amount)
    yield 'blocks', [signed]
    yield 'post', state


@with_all_phases
@spec_state_test
def test_previous_epoch_attestation_included_late(spec, state):
    # an attestation from the previous epoch included at the edge of its
    # inclusion window (SLOTS_PER_EPOCH after its slot) is still valid
    next_epoch(spec, state)
    next_epoch(spec, state)
    from ...helpers.state import transition_to

    att_slot = int(state.slot)
    attestation = get_valid_attestation(spec, state, slot=att_slot, signed=True)
    # the block lands exactly at the inclusion-window edge:
    # block.slot == att_slot + SLOTS_PER_EPOCH
    transition_to(spec, state, att_slot + int(spec.SLOTS_PER_EPOCH) - 1)
    yield 'pre', state
    block = build_empty_block_for_next_slot(spec, state)
    block.body.attestations = [attestation]
    signed = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed]
    yield 'post', state
