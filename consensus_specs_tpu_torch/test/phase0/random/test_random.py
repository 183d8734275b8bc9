"""Randomized full-transition scenarios — the spec's own asserts are the
oracle (machinery: helpers/random.py; fills the role of the reference's
code-generated random suites, generators/random/generate.py)."""
from random import Random

from ...context import spec_state_test, with_all_phases
from ...helpers.random import (
    randomize_balances, randomize_effective_balances, randomize_participation,
    run_random_scenario, slash_random_validators,
)
from ...helpers.state import next_epoch


@with_all_phases
@spec_state_test
def test_random_blocks_seed_1(spec, state):
    rng = Random(1)
    next_epoch(spec, state)
    yield 'pre', state
    blocks = run_random_scenario(spec, state, rng, slots=int(spec.SLOTS_PER_EPOCH))
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_random_blocks_seed_2_with_leak_shape(spec, state):
    rng = Random(2)
    # age the chain without attestations so finality lags
    for _ in range(3):
        next_epoch(spec, state)
    randomize_participation(spec, state, rng)
    yield 'pre', state
    blocks = run_random_scenario(spec, state, rng, slots=int(spec.SLOTS_PER_EPOCH))
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_random_with_slashed_and_odd_balances(spec, state):
    rng = Random(3)
    next_epoch(spec, state)
    randomize_balances(spec, state, rng)
    randomize_effective_balances(spec, state, rng)
    slashed = slash_random_validators(spec, state, rng, fraction=0.05)
    yield 'pre', state
    blocks = run_random_scenario(
        spec, state, rng, slots=int(spec.SLOTS_PER_EPOCH) + 2
    )
    yield 'blocks', blocks
    yield 'post', state
    for i in slashed:
        assert state.validators[i].slashed


@with_all_phases
@spec_state_test
def test_random_two_epochs_cross_boundary(spec, state):
    rng = Random(4)
    next_epoch(spec, state)
    yield 'pre', state
    blocks = run_random_scenario(
        spec, state, rng, slots=2 * int(spec.SLOTS_PER_EPOCH)
    )
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_random_blocks_seed_5_exits_mixed_in(spec, state):
    rng = Random(5)
    next_epoch(spec, state)
    # some validators already exiting when the scenario starts
    for index in rng.sample(range(len(state.validators)), 3):
        state.validators[index].exit_epoch = spec.get_current_epoch(state) + rng.randrange(2, 6)
    yield 'pre', state
    blocks = run_random_scenario(spec, state, rng, slots=int(spec.SLOTS_PER_EPOCH))
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_random_blocks_seed_6_low_balances(spec, state):
    rng = Random(6)
    next_epoch(spec, state)
    # push a handful near the ejection threshold so registry updates churn
    for index in rng.sample(range(len(state.validators)), 4):
        state.validators[index].effective_balance = spec.config.EJECTION_BALANCE
        state.balances[index] = spec.config.EJECTION_BALANCE
    yield 'pre', state
    blocks = run_random_scenario(spec, state, rng, slots=int(spec.SLOTS_PER_EPOCH) + 3)
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_random_blocks_seed_7_fresh_genesis(spec, state):
    rng = Random(7)
    yield 'pre', state
    blocks = run_random_scenario(spec, state, rng, slots=2 * int(spec.SLOTS_PER_EPOCH))
    yield 'blocks', blocks
    yield 'post', state


@with_all_phases
@spec_state_test
def test_random_blocks_seed_8_participation_noise(spec, state):
    rng = Random(8)
    next_epoch(spec, state)
    next_epoch(spec, state)
    randomize_participation(spec, state, rng)
    randomize_balances(spec, state, rng)
    yield 'pre', state
    blocks = run_random_scenario(spec, state, rng, slots=int(spec.SLOTS_PER_EPOCH))
    yield 'blocks', blocks
    yield 'post', state
