"""Rewards-delta checking engine.

Own design; fills the role of the reference's test/helpers/rewards.py
``run_deltas`` (511 LoC): every component of the epoch reward pass is
recomputed here INDEPENDENTLY (same formulas, restructured per-validator)
and compared exactly against the spec's vectorized accessors, then the
component sum is checked against ``get_attestation_deltas`` /
``process_rewards_and_penalties``'s balance effect.

Spec cites: reference specs/phase0/beacon-chain.md:1463-1560 (components +
get_attestation_deltas), specs/altair/beacon-chain.md:364-407 (flag deltas +
inactivity).
"""
from .forks import is_post_altair


def _zeros(spec, state):
    return [spec.Gwei(0)] * len(state.validators)




# ---------------------------------------------------------------------------
# phase0 component expectations (beacon-chain.md:1463-1534)
# ---------------------------------------------------------------------------


def expected_attestation_component(spec, state, attestations):
    """(rewards, penalties) for one matching component, per-validator."""
    rewards, penalties = _zeros(spec, state), _zeros(spec, state)
    total_balance = spec.get_total_active_balance(state)
    unslashed = spec.get_unslashed_attesting_indices(state, attestations)
    attesting_balance = spec.get_total_balance(state, unslashed)
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    for index in spec.get_eligible_validator_indices(state):
        base = spec.get_base_reward(state, index)
        if index in unslashed:
            if spec.is_in_inactivity_leak(state):
                rewards[index] += base
            else:
                numerator = base * (attesting_balance // increment)
                rewards[index] += spec.Gwei(numerator // (total_balance // increment))
        else:
            penalties[index] += base
    return rewards, penalties


def expected_inclusion_delay(spec, state):
    rewards = _zeros(spec, state)
    attestations = spec.get_matching_source_attestations(
        state, spec.get_previous_epoch(state)
    )
    for index in spec.get_unslashed_attesting_indices(state, attestations):
        earliest = min(
            (a for a in attestations
             if index in spec.get_attesting_indices(state, a.data, a.aggregation_bits)),
            key=lambda a: a.inclusion_delay,
        )
        base = spec.get_base_reward(state, index)
        proposer_reward = spec.Gwei(base // spec.PROPOSER_REWARD_QUOTIENT)
        rewards[earliest.proposer_index] += proposer_reward
        max_attester_reward = spec.Gwei(base - proposer_reward)
        rewards[index] += spec.Gwei(max_attester_reward // earliest.inclusion_delay)
    return rewards, _zeros(spec, state)


def expected_inactivity_phase0(spec, state):
    penalties = _zeros(spec, state)
    if spec.is_in_inactivity_leak(state):
        matching_target = spec.get_matching_target_attestations(
            state, spec.get_previous_epoch(state)
        )
        target_indices = spec.get_unslashed_attesting_indices(state, matching_target)
        for index in spec.get_eligible_validator_indices(state):
            base = spec.get_base_reward(state, index)
            penalties[index] += spec.Gwei(
                spec.BASE_REWARDS_PER_EPOCH * base - spec.get_proposer_reward(state, index)
            )
            if index not in target_indices:
                effective = state.validators[index].effective_balance
                penalties[index] += spec.Gwei(
                    effective * spec.get_finality_delay(state)
                    // spec.INACTIVITY_PENALTY_QUOTIENT
                )
    return _zeros(spec, state), penalties


# ---------------------------------------------------------------------------
# altair component expectations (altair/beacon-chain.md:364-407)
# ---------------------------------------------------------------------------


def expected_flag_deltas(spec, state, flag_index):
    rewards, penalties = _zeros(spec, state), _zeros(spec, state)
    previous_epoch = spec.get_previous_epoch(state)
    unslashed = spec.get_unslashed_participating_indices(
        state, flag_index, previous_epoch
    )
    weight = spec.PARTICIPATION_FLAG_WEIGHTS[flag_index]
    increment = spec.EFFECTIVE_BALANCE_INCREMENT
    participating_increments = spec.get_total_balance(state, unslashed) // increment
    active_increments = spec.get_total_active_balance(state) // increment
    for index in spec.get_eligible_validator_indices(state):
        base = spec.get_base_reward(state, index)
        if index in unslashed:
            if not spec.is_in_inactivity_leak(state):
                numerator = base * weight * participating_increments
                rewards[index] += spec.Gwei(
                    numerator // (active_increments * spec.WEIGHT_DENOMINATOR)
                )
        elif flag_index != spec.TIMELY_HEAD_FLAG_INDEX:
            penalties[index] += spec.Gwei(base * weight // spec.WEIGHT_DENOMINATOR)
    return rewards, penalties


def expected_inactivity_altair(spec, state):
    rewards, penalties = _zeros(spec, state), _zeros(spec, state)
    previous_epoch = spec.get_previous_epoch(state)
    matching_target = spec.get_unslashed_participating_indices(
        state, spec.TIMELY_TARGET_FLAG_INDEX, previous_epoch
    )
    for index in spec.get_eligible_validator_indices(state):
        if index not in matching_target:
            numerator = (
                state.validators[index].effective_balance
                * state.inactivity_scores[index]
            )
            denominator = (
                spec.config.INACTIVITY_SCORE_BIAS
                * spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR
            )
            penalties[index] += spec.Gwei(numerator // denominator)
    return rewards, penalties


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------


def _check_component(spec, state, name, got, expected):
    got_rewards, got_penalties = got
    exp_rewards, exp_penalties = expected
    n = len(state.validators)
    assert len(got_rewards) == len(got_penalties) == n, name
    assert list(got_rewards) == list(exp_rewards), (
        f"{name} rewards mismatch: {[(i, int(a), int(b)) for i, (a, b) in enumerate(zip(got_rewards, exp_rewards)) if a != b][:5]}"
    )
    assert list(got_penalties) == list(exp_penalties), (
        f"{name} penalties mismatch: {[(i, int(a), int(b)) for i, (a, b) in enumerate(zip(got_penalties, exp_penalties)) if a != b][:5]}"
    )
    # eligibility invariant: ineligible validators never move
    eligible = set(spec.get_eligible_validator_indices(state))
    for i in range(n):
        if i not in eligible:
            assert int(got_rewards[i]) == 0 and int(got_penalties[i]) == 0, (name, i)


def run_deltas(spec, state):
    """Validate every reward component on ``state`` (which must be at an
    epoch boundary position, i.e. ready for process_rewards_and_penalties),
    then the total. Yields the components as test-vector parts."""
    if is_post_altair(spec):
        components = []
        for flag_index in range(len(spec.PARTICIPATION_FLAG_WEIGHTS)):
            name = f"flag_{flag_index}_deltas"
            got = spec.get_flag_index_deltas(state, flag_index)
            _check_component(
                spec, state, name, got, expected_flag_deltas(spec, state, flag_index)
            )
            components.append((name, got))
            yield name, "data", _serialize_deltas(got)
        got = spec.get_inactivity_penalty_deltas(state)
        _check_component(
            spec, state, "inactivity_penalty_deltas", got,
            expected_inactivity_altair(spec, state),
        )
        components.append(("inactivity_penalty_deltas", got))
        yield "inactivity_penalty_deltas", "data", _serialize_deltas(got)
        return

    previous_epoch = spec.get_previous_epoch(state)
    for name, attestations in (
        ("source_deltas", spec.get_matching_source_attestations(state, previous_epoch)),
        ("target_deltas", spec.get_matching_target_attestations(state, previous_epoch)),
        ("head_deltas", spec.get_matching_head_attestations(state, previous_epoch)),
    ):
        got = getattr(spec, "get_" + name)(state)
        _check_component(
            spec, state, name, got,
            expected_attestation_component(spec, state, attestations),
        )
        yield name, "data", _serialize_deltas(got)

    got = spec.get_inclusion_delay_deltas(state)
    _check_component(
        spec, state, "inclusion_delay_deltas", got, expected_inclusion_delay(spec, state)
    )
    # inclusion delay never penalizes (beacon-chain.md:1510-1526)
    assert all(int(p) == 0 for p in got[1])
    yield "inclusion_delay_deltas", "data", _serialize_deltas(got)

    got = spec.get_inactivity_penalty_deltas(state)
    _check_component(
        spec, state, "inactivity_penalty_deltas", got,
        expected_inactivity_phase0(spec, state),
    )
    assert all(int(r) == 0 for r in got[0])  # penalties-only component
    yield "inactivity_penalty_deltas", "data", _serialize_deltas(got)

    # total: get_attestation_deltas == sum of the five components
    total_rewards, total_penalties = spec.get_attestation_deltas(state)
    sums_r = [0] * len(state.validators)
    sums_p = [0] * len(state.validators)
    for name, attestations in (
        ("source", spec.get_matching_source_attestations(state, previous_epoch)),
        ("target", spec.get_matching_target_attestations(state, previous_epoch)),
        ("head", spec.get_matching_head_attestations(state, previous_epoch)),
    ):
        r, p = expected_attestation_component(spec, state, attestations)
        sums_r = [a + int(b) for a, b in zip(sums_r, r)]
        sums_p = [a + int(b) for a, b in zip(sums_p, p)]
    for fn in (expected_inclusion_delay, expected_inactivity_phase0):
        r, p = fn(spec, state)
        sums_r = [a + int(b) for a, b in zip(sums_r, r)]
        sums_p = [a + int(b) for a, b in zip(sums_p, p)]
    assert [int(x) for x in total_rewards] == sums_r
    assert [int(x) for x in total_penalties] == sums_p


def _serialize_deltas(deltas):
    rewards, penalties = deltas
    return {
        "rewards": [int(x) for x in rewards],
        "penalties": [int(x) for x in penalties],
    }


def prepare_rewards_state(spec, state):
    """Advance ``state`` to the point process_rewards_and_penalties would
    run (one slot before the epoch boundary, slot processing applied)."""
    from .epoch_processing import run_epoch_processing_to

    run_epoch_processing_to(spec, state, "process_rewards_and_penalties")


def run_deltas_at_boundary(spec, state):
    prepare_rewards_state(spec, state)
    yield from run_deltas(spec, state)
