"""Code-generated randomized scenario-matrix tests — DO NOT EDIT.

Regenerate with `python tools/torch_gen_random_tests.py`; the
vocabulary/matrix lives in test/utils/scenario_matrix.py. Mirrors the
reference's code-generated random suites (reference
tests/generators/random/generate.py)."""
from ...context import PHASE0, spec_state_test, with_phases
from ...utils.scenario_matrix import run_matrix_scenario


@with_phases([PHASE0])
@spec_state_test
def test_random_fresh_epoch_start_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='fresh', timing='epoch_start', stressor='calm',
        seed=10000,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_fresh_mid_epoch_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='fresh', timing='mid_epoch', stressor='calm',
        seed=10001,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_fresh_epoch_tail_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='fresh', timing='epoch_tail', stressor='calm',
        seed=10002,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_shuffled_balances_epoch_start_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_start', stressor='calm',
        seed=10003,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_shuffled_balances_epoch_start_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_start', stressor='leaking',
        seed=10004,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_shuffled_balances_mid_epoch_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='mid_epoch', stressor='calm',
        seed=10005,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_shuffled_balances_mid_epoch_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='mid_epoch', stressor='leaking',
        seed=10006,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_shuffled_balances_epoch_tail_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_tail', stressor='calm',
        seed=10007,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_shuffled_balances_epoch_tail_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_tail', stressor='leaking',
        seed=10008,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_battle_scarred_epoch_start_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_start', stressor='calm',
        seed=10009,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_battle_scarred_epoch_start_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_start', stressor='leaking',
        seed=10010,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_battle_scarred_mid_epoch_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='mid_epoch', stressor='calm',
        seed=10011,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_battle_scarred_mid_epoch_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='mid_epoch', stressor='leaking',
        seed=10012,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_battle_scarred_epoch_tail_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_tail', stressor='calm',
        seed=10013,
    )


@with_phases([PHASE0])
@spec_state_test
def test_random_battle_scarred_epoch_tail_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_tail', stressor='leaking',
        seed=10014,
    )

