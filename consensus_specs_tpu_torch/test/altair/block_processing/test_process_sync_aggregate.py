"""process_sync_aggregate tests — the 512-wide second BLS hot path
(spec: reference specs/altair/beacon-chain.md:535-565; scenario coverage
modeled on the reference's altair/block_processing/sync_aggregate suite,
written for this harness).
"""
from ...context import (
    ALTAIR, always_bls, default_activation_threshold, low_balances,
    misc_balances, spec_state_test, spec_test, with_custom_state, with_phases,
)
from ...helpers.state import transition_to
from ...helpers.sync_committee import (
    build_sync_aggregate,
    compute_aggregate_sync_committee_signature,
    compute_sync_committee_participant_reward_and_penalty,
    get_committee_indices,
)


def _prepare(spec, state):
    # move off genesis so previous-slot block roots exist
    transition_to(spec, state, state.slot + 3)


def run_sync_aggregate_processing(spec, state, sync_aggregate, valid=True):
    from ...context import expect_assertion_error

    yield 'pre', state
    yield 'sync_aggregate', sync_aggregate

    if not valid:
        expect_assertion_error(
            lambda: spec.process_sync_aggregate(state, sync_aggregate)
        )
        yield 'post', None
        return

    committee_indices = get_committee_indices(spec, state)
    participant_reward, proposer_reward = (
        compute_sync_committee_participant_reward_and_penalty(spec, state)
    )
    proposer_index = spec.get_beacon_proposer_index(state)
    pre_balances = [int(b) for b in state.balances]

    spec.process_sync_aggregate(state, sync_aggregate)

    # reconstruct the expected balance deltas seat by seat
    expected = list(pre_balances)
    for seat, bit in zip(committee_indices, sync_aggregate.sync_committee_bits):
        if bit:
            expected[seat] += int(participant_reward)
            expected[proposer_index] += int(proposer_reward)
        else:
            expected[seat] = max(0, expected[seat] - int(participant_reward))
    assert [int(b) for b in state.balances] == expected

    yield 'post', state


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_full_participation(spec, state):
    _prepare(spec, state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    sync_aggregate = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate)


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_empty_participation(spec, state):
    # zero participants with the infinity-point signature is explicitly valid
    # (reference specs/altair/bls.md:59-68)
    _prepare(spec, state)
    bits = [False] * int(spec.SYNC_COMMITTEE_SIZE)
    sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=bits,
        sync_committee_signature=spec.G2_POINT_AT_INFINITY,
    )
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate)


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_half_participation(spec, state):
    _prepare(spec, state)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    bits = [i % 2 == 0 for i in range(size)]
    sync_aggregate = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_zeroed_with_participation(spec, state):
    # participants claimed but the signature is the zero encoding
    _prepare(spec, state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    sync_aggregate = spec.SyncAggregate(sync_committee_bits=bits)
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate, valid=False)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_infinity_with_participation(spec, state):
    # the infinity signature is only acceptable for empty participation
    _prepare(spec, state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=bits,
        sync_committee_signature=spec.G2_POINT_AT_INFINITY,
    )
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate, valid=False)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_missing_participant(spec, state):
    # one claimed participant did not actually sign
    _prepare(spec, state)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    committee_indices = get_committee_indices(spec, state)
    bits = [True] * size
    signers = [committee_indices[i] for i in range(size) if i != 0]
    signature = compute_aggregate_sync_committee_signature(
        spec, state, state.slot, signers
    )
    sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=bits, sync_committee_signature=signature
    )
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate, valid=False)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_extra_participant(spec, state):
    # signature covers a seat whose bit is cleared
    _prepare(spec, state)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    committee_indices = get_committee_indices(spec, state)
    bits = [i != 0 for i in range(size)]
    signers = list(committee_indices)  # includes seat 0
    signature = compute_aggregate_sync_committee_signature(
        spec, state, state.slot, signers
    )
    sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=bits, sync_committee_signature=signature
    )
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate, valid=False)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_wrong_root(spec, state):
    # correct signers, wrong message (a bogus block root)
    _prepare(spec, state)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    committee_indices = get_committee_indices(spec, state)
    bits = [True] * size
    signature = compute_aggregate_sync_committee_signature(
        spec, state, state.slot, committee_indices, block_root=b'\x25' * 32
    )
    sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=bits, sync_committee_signature=signature
    )
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate, valid=False)


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_rewards_duplicate_committee_member(spec, state):
    # minimal preset committees (32 seats over 64 validators) routinely seat
    # the same validator more than once; each seat rewards/penalizes
    # independently — the runner's seat-by-seat model checks exactly that
    _prepare(spec, state)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    committee_indices = get_committee_indices(spec, state)
    assert len(set(committee_indices)) <= size  # duplicates possible
    bits = [i % 4 != 0 for i in range(size)]
    sync_aggregate = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate)


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_proposer_in_committee(spec, state):
    # proposer earns both its seat reward (if participating) and the
    # per-participant proposer reward
    _prepare(spec, state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    sync_aggregate = build_sync_aggregate(spec, state, bits)
    proposer = spec.get_beacon_proposer_index(state)
    committee_indices = get_committee_indices(spec, state)
    yield from run_sync_aggregate_processing(spec, state, sync_aggregate)
    # informational: whether the proposer held a seat in this committee
    _ = proposer in committee_indices


def _random_bits(spec, fraction_num, fraction_den, seed):
    """Seeded random participation pattern covering ~fraction_num/fraction_den
    of the committee."""
    from random import Random

    rng = Random(seed)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    return [rng.randrange(fraction_den) < fraction_num for _ in range(size)]


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_random_three_quarters(spec, state):
    _prepare(spec, state)
    bits = _random_bits(spec, 3, 4, seed=1)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_random_quarter(spec, state):
    _prepare(spec, state)
    bits = _random_bits(spec, 1, 4, seed=2)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_single_participant(spec, state):
    _prepare(spec, state)
    bits = [False] * int(spec.SYNC_COMMITTEE_SIZE)
    bits[0] = True
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_all_but_one(spec, state):
    _prepare(spec, state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    bits[-1] = False
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_with_slashed_participant(spec, state):
    # slashing does not evict a sync-committee seat: a slashed member still
    # participates and is paid the seat reward
    _prepare(spec, state)
    committee = get_committee_indices(spec, state)
    state.validators[committee[0]].slashed = True
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_with_exited_participant(spec, state):
    _prepare(spec, state)
    committee = get_committee_indices(spec, state)
    validator = state.validators[committee[0]]
    validator.exit_epoch = spec.get_current_epoch(state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_wrong_domain(spec, state):
    # correct message, wrong domain: signed under DOMAIN_BEACON_ATTESTER
    _prepare(spec, state)
    from ...helpers.keys import privkeys

    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    committee = get_committee_indices(spec, state)
    previous_slot = state.slot - 1
    block_root = spec.get_block_root_at_slot(state, previous_slot)
    domain = spec.get_domain(
        state, spec.DOMAIN_BEACON_ATTESTER, spec.compute_epoch_at_slot(previous_slot)
    )
    signing_root = spec.compute_signing_root(spec.Root(block_root), domain)
    signature = spec.bls.Aggregate([
        spec.bls.Sign(privkeys[index], signing_root) for index in committee
    ])
    aggregate = spec.SyncAggregate(
        sync_committee_bits=bits, sync_committee_signature=signature,
    )
    yield from run_sync_aggregate_processing(spec, state, aggregate, valid=False)


@with_phases([ALTAIR])
@spec_state_test
def test_proposer_reward_sums_over_participants(spec, state):
    _prepare(spec, state)
    bits = _random_bits(spec, 1, 2, seed=3)
    proposer_index = spec.get_beacon_proposer_index(state)
    committee = get_committee_indices(spec, state)
    # keep the proposer out of the committee accounting for a clean check
    if proposer_index in committee:
        import pytest
        pytest.skip("proposer holds a committee seat in this state")
    _, proposer_reward = compute_sync_committee_participant_reward_and_penalty(spec, state)
    pre = int(state.balances[proposer_index])

    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )

    assert int(state.balances[proposer_index]) == pre + sum(bits) * int(proposer_reward)


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_random_pattern_seed_4(spec, state):
    _prepare(spec, state)
    bits = _random_bits(spec, 2, 3, seed=4)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_random_pattern_seed_5(spec, state):
    _prepare(spec, state)
    bits = _random_bits(spec, 1, 8, seed=5)
    if not any(bits):
        bits[0] = True
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_with_low_balance_participant(spec, state):
    # seat rewards key off base rewards, not the member's own balance
    _prepare(spec, state)
    committee = get_committee_indices(spec, state)
    state.balances[committee[0]] = spec.Gwei(1)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_nonparticipant_with_zero_balance_floors(spec, state):
    # the penalty saturates at zero balance rather than underflowing
    _prepare(spec, state)
    committee = get_committee_indices(spec, state)
    state.balances[committee[-1]] = spec.Gwei(0)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    bits[-1] = False
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_signed_over_past_root(spec, state):
    # a correct committee signing the root from TWO slots back instead of the
    # previous slot — the realistic stale-view mistake (the message is the
    # previous slot's block root, reference specs/altair/beacon-chain.md:540-545).
    # Skipped slots repeat the last real block root, so plant a distinct root
    # two slots back to make the staleness observable.
    transition_to(spec, state, state.slot + 4)
    idx = (int(state.slot) - 2) % int(spec.SLOTS_PER_HISTORICAL_ROOT)
    state.block_roots[idx] = spec.Root(b"\x42" * 32)
    past_root = spec.get_block_root_at_slot(state, state.slot - 2)
    assert past_root != spec.get_block_root_at_slot(state, state.slot - 1)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    sync_aggregate = build_sync_aggregate(
        spec, state, bits, block_root=past_root
    )
    yield from run_sync_aggregate_processing(
        spec, state, sync_aggregate, valid=False
    )


def _transition_across_period_boundary(spec, state):
    """Advance to the first slot of the next sync-committee period (the
    epoch-processing rotation at specs/altair/beacon-chain.md:669-679)."""
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    current_epoch = int(spec.get_current_epoch(state))
    target_epoch = (current_epoch // period_epochs + 1) * period_epochs
    transition_to(
        spec, state, target_epoch * int(spec.SLOTS_PER_EPOCH) + 1
    )


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_sync_committee_after_period_rotation(spec, state):
    # full participation right after the committee rotated in: the aggregate
    # must verify against the NEW current_sync_committee
    pre_next = list(state.next_sync_committee.pubkeys)
    _transition_across_period_boundary(spec, state)
    # rotation happened: what was "next" is now "current"
    assert list(state.current_sync_committee.pubkeys) == pre_next
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_invalid_signature_previous_committee_after_rotation(spec, state):
    # seats signed by the PRE-rotation committee's members after the period
    # boundary: bits index the new committee, so the aggregate cannot verify
    # unless the two committees' pubkey MULTISETS coincide (the aggregate
    # only sees the key sum; guarded below)
    from ...helpers.keys import privkeys

    old_seats = get_committee_indices(spec, state)
    _transition_across_period_boundary(spec, state)
    new_seats = get_committee_indices(spec, state)
    if sorted(old_seats) == sorted(new_seats):
        # astronomically unlikely sampling coincidence; make the mismatch
        # explicit rather than asserting a vacuous failure
        old_seats = old_seats[:-1] + [(old_seats[-1] + 1) % len(state.validators)]
    from ...helpers.sync_committee import compute_sync_committee_signing_root

    signing_root = compute_sync_committee_signing_root(spec, state, state.slot)
    signature = spec.bls.Aggregate(
        [spec.bls.Sign(privkeys[i], signing_root) for i in old_seats]
    )
    sync_aggregate = spec.SyncAggregate(
        sync_committee_bits=[True] * int(spec.SYNC_COMMITTEE_SIZE),
        sync_committee_signature=signature,
    )
    yield from run_sync_aggregate_processing(
        spec, state, sync_aggregate, valid=False
    )


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=misc_balances,
                   threshold_fn=default_activation_threshold)
@always_bls
def test_sync_committee_misc_balances(spec, state):
    # mixed effective balances change base rewards but not the seat
    # accounting; full participation must still verify and pay per seat
    _prepare(spec, state)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=low_balances,
                   threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
@always_bls
def test_sync_committee_low_balances(spec, state):
    # a committee drawn from a low-effective-balance registry: rewards
    # shrink with total active balance but the verification is unchanged
    _prepare(spec, state)
    size = int(spec.SYNC_COMMITTEE_SIZE)
    bits = [i % 3 != 0 for i in range(size)]
    yield from run_sync_aggregate_processing(
        spec, state, build_sync_aggregate(spec, state, bits)
    )
