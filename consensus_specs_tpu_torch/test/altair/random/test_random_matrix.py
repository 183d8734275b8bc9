"""Code-generated randomized scenario-matrix tests — DO NOT EDIT.

Regenerate with `python tools/torch_gen_random_tests.py`; the
vocabulary/matrix lives in test/utils/scenario_matrix.py. Mirrors the
reference's code-generated random suites (reference
tests/generators/random/generate.py)."""
from ...context import ALTAIR, spec_state_test, with_phases
from ...utils.scenario_matrix import run_matrix_scenario


@with_phases([ALTAIR])
@spec_state_test
def test_random_fresh_epoch_start_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='fresh', timing='epoch_start', stressor='calm',
        seed=20000,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_fresh_mid_epoch_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='fresh', timing='mid_epoch', stressor='calm',
        seed=20001,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_fresh_epoch_tail_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='fresh', timing='epoch_tail', stressor='calm',
        seed=20002,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_shuffled_balances_epoch_start_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_start', stressor='calm',
        seed=20003,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_shuffled_balances_epoch_start_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_start', stressor='leaking',
        seed=20004,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_shuffled_balances_mid_epoch_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='mid_epoch', stressor='calm',
        seed=20005,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_shuffled_balances_mid_epoch_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='mid_epoch', stressor='leaking',
        seed=20006,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_shuffled_balances_epoch_tail_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_tail', stressor='calm',
        seed=20007,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_shuffled_balances_epoch_tail_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='shuffled_balances', timing='epoch_tail', stressor='leaking',
        seed=20008,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_battle_scarred_epoch_start_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_start', stressor='calm',
        seed=20009,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_battle_scarred_epoch_start_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_start', stressor='leaking',
        seed=20010,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_battle_scarred_mid_epoch_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='mid_epoch', stressor='calm',
        seed=20011,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_battle_scarred_mid_epoch_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='mid_epoch', stressor='leaking',
        seed=20012,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_battle_scarred_epoch_tail_calm(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_tail', stressor='calm',
        seed=20013,
    )


@with_phases([ALTAIR])
@spec_state_test
def test_random_battle_scarred_epoch_tail_leaking(spec, state):
    yield from run_matrix_scenario(
        spec, state,
        profile='battle_scarred', timing='epoch_tail', stressor='leaking',
        seed=20014,
    )

