"""process_slashings tests
(reference: test/phase0/epoch_processing/test_process_slashings.py)."""
from ...context import spec_state_test, with_all_phases
from ...helpers.epoch_processing import run_epoch_processing_to, run_epoch_processing_with


def slash_validators(spec, state, indices, out_epochs):
    total_slashed_balance = 0
    for i, out_epoch in zip(indices, out_epochs):
        v = state.validators[i]
        v.slashed = True
        spec.initiate_validator_exit(state, i)
        v.withdrawable_epoch = out_epoch
        total_slashed_balance += v.effective_balance

    state.slashings[
        spec.get_current_epoch(state) % spec.EPOCHS_PER_SLASHINGS_VECTOR
    ] = total_slashed_balance


def get_slashing_multiplier(spec):
    # v1.1.3: merge carries altair's slashing parameters unchanged
    if spec.fork in ("altair", "merge"):
        return spec.PROPORTIONAL_SLASHING_MULTIPLIER_ALTAIR
    return spec.PROPORTIONAL_SLASHING_MULTIPLIER


@with_all_phases
@spec_state_test
def test_max_penalties(spec, state):
    # slash enough validators that multiplier * slashed balance >= total balance,
    # so the adjusted slashing balance saturates and penalties hit 100%
    slashed_count = min(
        len(state.validators),
        len(state.validators) // get_slashing_multiplier(spec) + 1,
    )
    out_epoch = spec.get_current_epoch(state) + (spec.EPOCHS_PER_SLASHINGS_VECTOR // 2)

    slashed_indices = list(range(slashed_count))
    slash_validators(spec, state, slashed_indices, [out_epoch] * slashed_count)

    total_balance = spec.get_total_active_balance(state)
    total_penalties = sum(state.slashings)

    assert total_balance // get_slashing_multiplier(spec) <= total_penalties

    yield from run_epoch_processing_with(spec, state, 'process_slashings')

    for i in slashed_indices:
        assert state.balances[i] == 0


@with_all_phases
@spec_state_test
def test_minimal_penalty(spec, state):
    # Just the bare minimum for this one validator
    state.balances[0] = state.validators[0].effective_balance = spec.config.EJECTION_BALANCE
    # All the other validators get the maximum.
    for i in range(1, len(state.validators)):
        state.validators[i].effective_balance = state.balances[i] = spec.MAX_EFFECTIVE_BALANCE

    out_epoch = spec.get_current_epoch(state) + (spec.EPOCHS_PER_SLASHINGS_VECTOR // 2)

    slash_validators(spec, state, [0], [out_epoch])

    total_balance = spec.get_total_active_balance(state)
    total_penalties = sum(state.slashings)

    assert total_balance // 3 > total_penalties

    run_epoch_processing_to(spec, state, 'process_slashings')
    pre_slash_balances = list(state.balances)

    yield 'pre', state
    spec.process_slashings(state)
    yield 'post', state

    expected_penalty = (
        state.validators[0].effective_balance // spec.EFFECTIVE_BALANCE_INCREMENT
        * (get_slashing_multiplier(spec) * total_penalties)
        // total_balance
        * spec.EFFECTIVE_BALANCE_INCREMENT
    )

    assert state.balances[0] == pre_slash_balances[0] - expected_penalty


@with_all_phases
@spec_state_test
def test_empty_slashings(spec, state):
    # no slashings, no penalties
    yield from run_epoch_processing_with(spec, state, 'process_slashings')


@with_all_phases
@spec_state_test
def test_scaled_penalties(spec, state):
    # slash ~6% of the set: penalties scale with the slashed fraction and
    # round down to whole effective-balance increments
    from random import Random

    rng = Random(5050)
    n = len(state.validators)
    count = max(2, n // 16)
    indices = rng.sample(range(n), count)
    # diversify effective balances below the max
    for j, i in enumerate(indices):
        state.validators[i].effective_balance = spec.Gwei(
            int(spec.MAX_EFFECTIVE_BALANCE)
            - (j % 3) * int(spec.EFFECTIVE_BALANCE_INCREMENT)
        )
    out_epoch = spec.get_current_epoch(state) + (
        spec.EPOCHS_PER_SLASHINGS_VECTOR // 2
    )
    slash_validators(spec, state, indices, [out_epoch] * count)

    total_balance = spec.get_total_active_balance(state)
    total_penalties = sum(state.slashings)

    # capture balances only after the earlier sub-passes ran (they may
    # touch balances once the start state is not genesis)
    run_epoch_processing_to(spec, state, 'process_slashings')
    pre_balances = [int(state.balances[i]) for i in indices]
    yield 'pre', state
    spec.process_slashings(state)
    yield 'post', state

    for i, pre in zip(indices, pre_balances):
        v = state.validators[i]
        expected_penalty = (
            int(v.effective_balance) // int(spec.EFFECTIVE_BALANCE_INCREMENT)
            * min(int(total_penalties) * int(get_slashing_multiplier(spec)), int(total_balance))
            // int(total_balance)
            * int(spec.EFFECTIVE_BALANCE_INCREMENT)
        )
        assert int(state.balances[i]) == pre - expected_penalty


@with_all_phases
@spec_state_test
def test_no_penalty_outside_withdrawable_window(spec, state):
    # a slashed validator whose halfway-point epoch is elsewhere takes no
    # penalty from this pass
    slash_validators(
        spec, state, [1],
        [spec.get_current_epoch(state) + spec.EPOCHS_PER_SLASHINGS_VECTOR // 4],
    )
    pre = int(state.balances[1])
    yield from run_epoch_processing_with(spec, state, 'process_slashings')
    assert int(state.balances[1]) == pre


@with_all_phases
@spec_state_test
def test_low_penalty(spec, state):
    # a single small slashing: the proportional penalty rounds down to the
    # increment granularity (possibly zero) without underflow
    from ...helpers.state import next_epoch

    next_epoch(spec, state)
    cur = spec.get_current_epoch(state)
    window = spec.EPOCHS_PER_SLASHINGS_VECTOR // 2
    slash_validators(spec, state, [4], [cur + window])
    # shrink the recorded slashed balance to one increment
    state.slashings[cur % spec.EPOCHS_PER_SLASHINGS_VECTOR] = (
        spec.EFFECTIVE_BALANCE_INCREMENT
    )
    pre = int(state.balances[4])
    yield from run_epoch_processing_with(spec, state, 'process_slashings')
    assert int(state.balances[4]) <= pre


@with_all_phases
@spec_state_test
def test_slashings_with_random_state(spec, state):
    from random import Random

    from ...helpers.state import next_epoch

    rng = Random(7117)
    next_epoch(spec, state)
    cur = spec.get_current_epoch(state)
    window = spec.EPOCHS_PER_SLASHINGS_VECTOR // 2
    # random balances first, then a random stripe of slashed validators
    # landing exactly in the penalty window
    for i in range(len(state.validators)):
        state.balances[i] = spec.Gwei(rng.randrange(1, int(spec.MAX_EFFECTIVE_BALANCE * 2)))
    victims = sorted(rng.sample(range(len(state.validators)), 5))
    slash_validators(spec, state, victims, [cur + window] * len(victims))
    pre = [int(state.balances[v]) for v in victims]
    yield from run_epoch_processing_with(spec, state, 'process_slashings')
    for v, p in zip(victims, pre):
        assert int(state.balances[v]) <= p
