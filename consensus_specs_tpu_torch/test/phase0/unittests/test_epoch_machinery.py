"""Epoch-machinery unit checks, pytest-only (not vector-format cases)."""
from ...context import spec_state_test, with_all_phases
from ...helpers.state import next_epoch


def mock_deposit(spec, state, index):
    state.validators[index].activation_eligibility_epoch = spec.FAR_FUTURE_EPOCH
    state.validators[index].activation_epoch = spec.FAR_FUTURE_EPOCH
    state.validators[index].effective_balance = spec.MAX_EFFECTIVE_BALANCE


@with_all_phases
@spec_state_test
def test_historical_batch_written_at_boundary(spec, state):
    # place the state just under the historical-root horizon, then cross it:
    # process_historical_roots_update must append a batch
    limit = int(spec.SLOTS_PER_HISTORICAL_ROOT)
    state.slot = spec.Slot(limit - 1)
    assert len(state.historical_roots) == 0
    next_epoch(spec, state)
    assert len(state.historical_roots) > 0


@with_all_phases
@spec_state_test
def test_activation_epoch_respects_exit_lookahead(spec, state):
    # freshly finalized eligibility activates with the standard lookahead
    mock_deposit(spec, state, 5)
    state.validators[5].activation_eligibility_epoch = spec.get_current_epoch(state)
    state.finalized_checkpoint.epoch = spec.get_current_epoch(state)
    # run the pass directly (run_epoch_processing_with advances an epoch and
    # would shift the arithmetic)
    current = spec.get_current_epoch(state)
    spec.process_registry_updates(state)
    assert state.validators[5].activation_epoch >= spec.compute_activation_exit_epoch(current)


@with_all_phases
@spec_state_test
def test_churn_limit_floor_and_scaling(spec, state):
    # the churn limit floors at MIN_PER_EPOCH_CHURN_LIMIT for small sets and
    # scales as active_count // CHURN_LIMIT_QUOTIENT past the knee
    active = len(spec.get_active_validator_indices(state, spec.get_current_epoch(state)))
    limit = int(spec.get_validator_churn_limit(state))
    expected = max(
        int(spec.config.MIN_PER_EPOCH_CHURN_LIMIT),
        active // int(spec.config.CHURN_LIMIT_QUOTIENT),
    )
    assert limit == expected
    # the knee: the limit sits at the floor exactly while
    # active // quotient <= floor, i.e. active < (floor + 1) * quotient —
    # a biconditional, so neither side can pass vacuously
    floor = int(spec.config.MIN_PER_EPOCH_CHURN_LIMIT)
    quotient = int(spec.config.CHURN_LIMIT_QUOTIENT)
    assert (limit == floor) == (active < (floor + 1) * quotient)


@with_all_phases
@spec_state_test
def test_effective_balance_caps_at_max(spec, state):
    # a raw balance far above MAX_EFFECTIVE_BALANCE: the epoch update clamps
    # the effective balance at the cap, never above
    from ...helpers.epoch_processing import run_epoch_processing_to

    index = 11
    state.balances[index] = spec.Gwei(int(spec.MAX_EFFECTIVE_BALANCE) * 3)
    run_epoch_processing_to(spec, state, "process_effective_balance_updates")
    spec.process_effective_balance_updates(state)
    assert state.validators[index].effective_balance == spec.MAX_EFFECTIVE_BALANCE


@with_all_phases
@spec_state_test
def test_effective_balance_stable_inside_hysteresis_band(spec, state):
    # a small wiggle (less than the downward/upward hysteresis margins)
    # must NOT move the effective balance
    from ...helpers.epoch_processing import run_epoch_processing_to

    index = 12
    increment = int(spec.EFFECTIVE_BALANCE_INCREMENT)
    hysteresis = increment // int(spec.HYSTERESIS_QUOTIENT)
    pre_effective = int(state.validators[index].effective_balance)
    state.balances[index] = spec.Gwei(pre_effective + hysteresis)  # inside band
    run_epoch_processing_to(spec, state, "process_effective_balance_updates")
    spec.process_effective_balance_updates(state)
    assert int(state.validators[index].effective_balance) == pre_effective
