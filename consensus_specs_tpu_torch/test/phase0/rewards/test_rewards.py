"""Rewards-delta tests over the checking engine (helpers/rewards.py)
(spec: reference specs/phase0/beacon-chain.md:1463-1560,
specs/altair/beacon-chain.md:364-407; scenario coverage modeled on the
reference's rewards test tree, written for this harness)."""
from random import Random

from ...context import (
    PHASE0, low_balances, misc_balances, spec_state_test, spec_test,
    with_all_phases, with_custom_state, with_phases,
    default_activation_threshold, zero_activation_threshold,
)
from ...helpers.attestations import next_epoch_with_attestations
from ...helpers.rewards import run_deltas, run_deltas_at_boundary
from ...helpers.state import next_epoch


def _attested_state(spec, state, participation_fn=None):
    """One epoch of real attesting blocks, landing at the next epoch start
    (previous-epoch attestations / participation flags populated)."""
    next_epoch(spec, state)
    _, _, post = next_epoch_with_attestations(
        spec, state, True, False, participation_fn=participation_fn
    )
    return post


@with_all_phases
@spec_state_test
def test_empty_attestations(spec, state):
    # nobody attested last epoch: every eligible validator is penalized on
    # source/target/head (phase0) or every flag (altair); no rewards
    next_epoch(spec, state)
    next_epoch(spec, state)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_full_attestations(spec, state):
    state = _attested_state(spec, state)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_half_attestations(spec, state):
    def half(slot, index, committee):
        members = sorted(committee)
        return set(members[: max(1, len(members) // 2)])

    state = _attested_state(spec, state, participation_fn=half)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_random_attestations(spec, state):
    rng = Random(3456)

    def sample(slot, index, committee):
        return set(v for v in committee if rng.random() < 0.7)

    state = _attested_state(spec, state, participation_fn=sample)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_test
@with_custom_state(misc_balances, default_activation_threshold)
def test_full_attestations_misc_balances(spec, state):
    state = _attested_state(spec, state)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_test
@with_custom_state(low_balances, zero_activation_threshold)
def test_full_attestations_low_balances(spec, state):
    state = _attested_state(spec, state)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_slashed_validators_penalized(spec, state):
    state = _attested_state(spec, state)
    # slash a few attesters after the fact: they are excluded from the
    # unslashed sets and penalized like absentees
    for index in list(spec.get_active_validator_indices(
        state, spec.get_current_epoch(state)
    ))[:3]:
        spec.slash_validator(state, index)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_inactivity_leak(spec, state):
    # stall finality long enough to trip the leak
    # (MIN_EPOCHS_TO_INACTIVITY_PENALTY, beacon-chain.md:1527-1546)
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2):
        next_epoch(spec, state)
    if hasattr(spec, "process_inactivity_updates"):
        # altair: give the inactivity scores something to bite on
        state.inactivity_scores = [
            spec.uint64(5 * int(spec.config.INACTIVITY_SCORE_BIAS))
        ] * len(state.validators)
    from ...helpers.rewards import prepare_rewards_state

    prepare_rewards_state(spec, state)
    assert spec.is_in_inactivity_leak(state)
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_leak_with_half_participation(spec, state):
    def half(slot, index, committee):
        members = sorted(committee)
        return set(members[: max(1, len(members) // 2)])

    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2):
        next_epoch(spec, state)
    _, _, state = next_epoch_with_attestations(
        spec, state, True, False, participation_fn=half
    )
    from ...helpers.rewards import prepare_rewards_state

    prepare_rewards_state(spec, state)
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_quarter_attestations(spec, state):
    def quarter(slot, index, committee):
        members = sorted(committee)
        return set(members[: max(1, len(members) // 4)])

    state = _attested_state(spec, state, participation_fn=quarter)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_one_attester_per_committee(spec, state):
    def lone(slot, index, committee):
        return {sorted(committee)[0]}

    state = _attested_state(spec, state, participation_fn=lone)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_random_attestations_alt_seed(spec, state):
    rng = Random(987654)

    def sample(slot, index, committee):
        picked = {m for m in committee if rng.randrange(3) == 0}
        return picked or {sorted(committee)[0]}

    state = _attested_state(spec, state, participation_fn=sample)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_exited_validators_no_deltas(spec, state):
    # exit validators BEFORE the attested epoch so committee composition is
    # consistent with the recorded attestations
    next_epoch(spec, state)
    for index in (1, 3):
        v = state.validators[index]
        v.exit_epoch = spec.get_current_epoch(state) + 1
        v.withdrawable_epoch = v.exit_epoch + 1
    next_epoch(spec, state)
    _, _, post = next_epoch_with_attestations(spec, state, True, False)
    state = post
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_some_slashed_some_exited(spec, state):
    next_epoch(spec, state)
    v = state.validators[2]
    v.exit_epoch = spec.get_current_epoch(state) + 1
    v.withdrawable_epoch = v.exit_epoch + 8
    next_epoch(spec, state)
    _, _, post = next_epoch_with_attestations(spec, state, True, False)
    state = post
    # slash AFTER the attested epoch: committees stay consistent and the
    # slashed-but-not-withdrawable validator remains eligible for penalties
    state.validators[0].slashed = True
    state.validators[0].withdrawable_epoch = spec.get_current_epoch(state) + 16
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_deep_leak_escalating_penalties(spec, state):
    # far into a leak, the inactivity penalties dominate
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 5):
        next_epoch(spec, state)
    assert spec.is_in_inactivity_leak(state)
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_leak_with_sparse_participation(spec, state):
    def sparse(slot, index, committee):
        members = sorted(committee)
        return set(members[: max(1, len(members) // 8)])

    next_epoch(spec, state)
    state, _, post = next_epoch_with_attestations(
        spec, state, True, False, participation_fn=sparse
    )
    state = post
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2):
        next_epoch(spec, state)
    if not spec.is_in_inactivity_leak(state):
        import pytest
        pytest.skip("state finalized despite sparse participation")
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_uneven_effective_balances(spec, state):
    state = _attested_state(spec, state)
    # shake up effective balances across the valid increments
    for i, v in enumerate(state.validators):
        steps = (i % 5)
        v.effective_balance = spec.Gwei(
            int(spec.MAX_EFFECTIVE_BALANCE)
            - steps * int(spec.EFFECTIVE_BALANCE_INCREMENT) // 2
        ) // int(spec.EFFECTIVE_BALANCE_INCREMENT) * int(spec.EFFECTIVE_BALANCE_INCREMENT)
    yield from run_deltas(spec, state)


# -- wrong-field vote shapes, duplicate participation,
#    activation/exit mixes, leak-duration bands, and tiny-balance edges ----


def _leaking_state(spec, state, extra_epochs=0):
    from ...helpers.state import advance_into_leak

    return advance_into_leak(spec, state, extra_epochs)


@with_all_phases
@spec_state_test
def test_genesis_epoch_full_attestations_no_deltas_engine(spec, state):
    # during the genesis epoch there is no previous epoch to account: the
    # engine must report all-zero previous-epoch deltas even with REAL
    # current-epoch votes recorded in the state
    from ...helpers.attestations import next_slots_with_attestations

    assert spec.get_current_epoch(state) == spec.GENESIS_EPOCH
    _, _, state = next_slots_with_attestations(
        spec, state, int(spec.SLOTS_PER_EPOCH) - 2, True, False
    )
    assert spec.get_current_epoch(state) == spec.GENESIS_EPOCH
    if hasattr(state, "current_epoch_attestations"):
        assert len(state.current_epoch_attestations) > 0
    yield from run_deltas(spec, state)


@with_all_phases
@spec_state_test
def test_one_validator_one_gwei_effective(spec, state):
    # the smallest nonzero effective balance: per-increment arithmetic
    # (base reward scales with sqrt of total balance) must stay exact
    state = _attested_state(spec, state)
    state.validators[3].effective_balance = spec.EFFECTIVE_BALANCE_INCREMENT
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_all_balances_below_increment(spec, state):
    # every effective balance at the minimum increment: rewards nearly
    # vanish but eligibility rules still apply
    state = _attested_state(spec, state)
    for v in state.validators:
        v.effective_balance = spec.EFFECTIVE_BALANCE_INCREMENT
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_not_yet_activated_validators_no_deltas(spec, state):
    # pending validators are ineligible: zero deltas for them. The pending
    # stripe is carved out BEFORE the attesting epoch so recorded committee
    # shapes stay consistent with the registry.
    future = spec.Epoch(10)
    for i in range(0, len(state.validators), 6):
        state.validators[i].activation_epoch = future
    state = _attested_state(spec, state)
    assert spec.get_current_epoch(state) < future
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_withdrawable_slashed_validators(spec, state):
    # slashed AND already withdrawable: drops out of the eligible set
    state = _attested_state(spec, state)
    cur = spec.get_current_epoch(state)
    for i in range(0, len(state.validators), 5):
        state.validators[i].slashed = True
        state.validators[i].withdrawable_epoch = cur
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_seven_epoch_leak(spec, state):
    _leaking_state(spec, state, extra_epochs=2)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_ten_epoch_leak(spec, state):
    _leaking_state(spec, state, extra_epochs=5)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_state_test
def test_leak_with_full_participation(spec, state):
    # a leak epoch where everyone nonetheless attests: participants are
    # made whole (phase0: rewards cancel) while nobody else is
    _leaking_state(spec, state)
    _, _, state = next_epoch_with_attestations(spec, state, False, True)
    assert spec.is_in_inactivity_leak(state)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_test
@with_custom_state(low_balances, zero_activation_threshold)
def test_leak_low_balances(spec, state):
    _leaking_state(spec, state)
    yield from run_deltas_at_boundary(spec, state)


@with_all_phases
@spec_test
@with_custom_state(misc_balances, default_activation_threshold)
def test_random_attestations_misc_balances(spec, state):
    rng = Random(90210)

    def sample(slot, index, committee):
        return set(v for v in committee if rng.random() < 0.6) or {sorted(committee)[0]}

    state = _attested_state(spec, state, participation_fn=sample)
    yield from run_deltas_at_boundary(spec, state)


# -- pending-attestation surgery scenarios (phase0: the queues are plain
#    state fields, so vote-shape and delay matrices are direct edits) ------


def _surgeried_state(spec, state, mutate):
    """An attested state whose previous-epoch pending attestations have been
    reshaped by ``mutate(pending_list)`` before the rewards pass runs."""
    state = _attested_state(spec, state)
    mutate(state.previous_epoch_attestations)
    return state


@with_phases([PHASE0])
@spec_state_test
def test_inclusion_delay_min_all(spec, state):
    # every vote lands at the minimum delay: maximal proposer+delay rewards
    def m(pending):
        for att in pending:
            att.inclusion_delay = spec.MIN_ATTESTATION_INCLUSION_DELAY
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_inclusion_delay_max_all(spec, state):
    # every vote lands at the last allowed slot: the delay reward floors
    # (base_reward // SLOTS_PER_EPOCH), never negative
    def m(pending):
        for att in pending:
            att.inclusion_delay = spec.SLOTS_PER_EPOCH
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_inclusion_delay_mixed(spec, state):
    # a spread of delays: the engine's min-delay-per-attester selection
    # (earliest inclusion wins) is what the spec pays
    def m(pending):
        for i, att in enumerate(pending):
            att.inclusion_delay = 1 + (i * 5) % int(spec.SLOTS_PER_EPOCH)
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_duplicate_pending_same_attester(spec, state):
    # the same vote recorded twice with different delays: each attester is
    # paid once, at the MINIMUM delay of its matching records
    def m(pending):
        dup = pending[0].copy()
        dup.inclusion_delay = spec.SLOTS_PER_EPOCH
        pending.append(dup)
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_correct_target_incorrect_head(spec, state):
    # head votes miss (wrong beacon_block_root) but targets hold: head
    # component penalizes everyone, target/source still reward
    def m(pending):
        for att in pending:
            att.data.beacon_block_root = spec.Root(b"\x36" * 32)
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_incorrect_target_all(spec, state):
    # target votes miss: target AND head components penalize (head matching
    # requires target matching in the engine's filtered sets)
    def m(pending):
        for att in pending:
            att.data.target.root = spec.Root(b"\x37" * 32)
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_half_incorrect_target_half_incorrect_head(spec, state):
    def m(pending):
        for i, att in enumerate(pending):
            if i % 2 == 0:
                att.data.target.root = spec.Root(b"\x38" * 32)
            else:
                att.data.beacon_block_root = spec.Root(b"\x39" * 32)
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_correct_target_incorrect_head_leak(spec, state):
    _leaking_state(spec, state)
    _, _, state = next_epoch_with_attestations(spec, state, False, True)
    assert spec.is_in_inactivity_leak(state)
    for att in state.previous_epoch_attestations:
        att.data.beacon_block_root = spec.Root(b"\x3a" * 32)
    yield from run_deltas_at_boundary(spec, state)


@with_phases([PHASE0])
@spec_state_test
def test_incorrect_target_all_leak(spec, state):
    # during a leak, wrong-target voters take the full inactivity penalty
    # as if absent
    _leaking_state(spec, state)
    _, _, state = next_epoch_with_attestations(spec, state, False, True)
    assert spec.is_in_inactivity_leak(state)
    for att in state.previous_epoch_attestations:
        att.data.target.root = spec.Root(b"\x3b" * 32)
    yield from run_deltas_at_boundary(spec, state)


@with_phases([PHASE0])
@spec_state_test
def test_single_proposer_concentration(spec, state):
    # all inclusion credit routed to one proposer: its reward accumulates
    # per attester while other proposers get nothing
    def m(pending):
        for att in pending:
            att.proposer_index = 1
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))


@with_phases([PHASE0])
@spec_state_test
def test_empty_bits_pending_attestation(spec, state):
    # a pending attestation with no participants contributes to no one —
    # present-but-empty records must not crash or reward
    def m(pending):
        ghost = pending[0].copy()
        ghost.aggregation_bits = type(ghost.aggregation_bits)(
            [0] * len(ghost.aggregation_bits)
        )
        pending.append(ghost)
    yield from run_deltas_at_boundary(spec, state=_surgeried_state(spec, state, m))
