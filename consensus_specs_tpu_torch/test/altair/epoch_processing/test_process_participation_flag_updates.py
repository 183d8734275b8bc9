"""process_participation_flag_updates tests
(spec: reference specs/altair/beacon-chain.md:659-667)."""
from random import Random

from ...context import ALTAIR, spec_state_test, with_phases
from ...helpers.epoch_processing import run_epoch_processing_with


def _randomize_flags(spec, state, rng):
    n = len(state.validators)
    state.previous_epoch_participation = [
        spec.ParticipationFlags(rng.randrange(8)) for _ in range(n)
    ]
    state.current_epoch_participation = [
        spec.ParticipationFlags(rng.randrange(8)) for _ in range(n)
    ]


@with_phases([ALTAIR])
@spec_state_test
def test_rotation(spec, state):
    _randomize_flags(spec, state, Random(2203))
    pre_current = list(state.current_epoch_participation)
    yield from run_epoch_processing_with(
        spec, state, 'process_participation_flag_updates'
    )
    assert list(state.previous_epoch_participation) == pre_current
    assert list(state.current_epoch_participation) == (
        [spec.ParticipationFlags(0)] * len(state.validators)
    )


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_all_zeroed(spec, state):
    n = len(state.validators)
    state.previous_epoch_participation = [spec.ParticipationFlags(7)] * n
    state.current_epoch_participation = [spec.ParticipationFlags(0)] * n
    yield from run_epoch_processing_with(
        spec, state, 'process_participation_flag_updates'
    )
    assert list(state.previous_epoch_participation) == [spec.ParticipationFlags(0)] * n
    assert list(state.current_epoch_participation) == [spec.ParticipationFlags(0)] * n


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_large_random(spec, state):
    _randomize_flags(spec, state, Random(40404))
    pre_current = list(state.current_epoch_participation)
    pre_previous = list(state.previous_epoch_participation)
    yield from run_epoch_processing_with(
        spec, state, 'process_participation_flag_updates'
    )
    # old previous-epoch flags are gone entirely
    assert list(state.previous_epoch_participation) == pre_current
    assert list(state.previous_epoch_participation) != pre_previous
    assert all(int(f) == 0 for f in state.current_epoch_participation)


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_tracks_registry_growth(spec, state):
    # deposits grow the registry (and both flag lists) mid-epoch; the
    # rotation must carry the longer current list into previous and zero a
    # fresh list of the same grown length
    from ...helpers.deposits import build_deposit_data
    from ...helpers.keys import privkeys, pubkeys

    _randomize_flags(spec, state, Random(99))
    n = len(state.validators)
    grown = n + 2
    for i in range(n, grown):
        # mirror process_deposit's registry append
        state.validators.append(spec.get_validator_from_deposit(
            state,
            spec.Deposit(data=build_deposit_data(
                spec, pubkeys[i],
                privkeys[i],
                spec.MAX_EFFECTIVE_BALANCE,
                spec.BLS_WITHDRAWAL_PREFIX + spec.hash(pubkeys[i])[1:],
                signed=True,
            )),
        ))
        state.balances.append(spec.MAX_EFFECTIVE_BALANCE)
        state.previous_epoch_participation.append(spec.ParticipationFlags(0))
        state.current_epoch_participation.append(spec.ParticipationFlags(0b101))
        state.inactivity_scores.append(spec.uint64(0))
    pre_current = list(state.current_epoch_participation)

    yield from run_epoch_processing_with(
        spec, state, 'process_participation_flag_updates'
    )
    assert list(state.previous_epoch_participation) == pre_current
    assert len(state.current_epoch_participation) == grown
    assert all(int(f) == 0 for f in state.current_epoch_participation)


def _run_rotation(spec, state, prev_flags, cur_flags):
    """Install the given flag lists, rotate, and assert the invariant pair:
    previous <- old current, current <- fresh zeros."""
    state.previous_epoch_participation = [spec.ParticipationFlags(f) for f in prev_flags]
    state.current_epoch_participation = [spec.ParticipationFlags(f) for f in cur_flags]
    pre_current = list(state.current_epoch_participation)
    yield from run_epoch_processing_with(
        spec, state, 'process_participation_flag_updates'
    )
    assert list(state.previous_epoch_participation) == pre_current
    assert all(int(f) == 0 for f in state.current_epoch_participation)
    assert len(state.current_epoch_participation) == len(state.validators)


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_both_filled(spec, state):
    n = len(state.validators)
    yield from _run_rotation(spec, state, [7] * n, [7] * n)


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_only_previous_filled(spec, state):
    n = len(state.validators)
    yield from _run_rotation(spec, state, [7] * n, [0] * n)


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_only_current_filled(spec, state):
    n = len(state.validators)
    yield from _run_rotation(spec, state, [0] * n, [7] * n)


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_at_genesis_epoch(spec, state):
    # the rotation is unconditional — it runs at the genesis epoch too
    assert spec.get_current_epoch(state) == spec.GENESIS_EPOCH
    rng = Random(777)
    n = len(state.validators)
    yield from _run_rotation(
        spec, state,
        [rng.randrange(8) for _ in range(n)],
        [rng.randrange(8) for _ in range(n)],
    )


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_single_flag_patterns(spec, state):
    # each flag bit alone, spread across the registry
    n = len(state.validators)
    yield from _run_rotation(
        spec, state,
        [(1 << (i % 3)) for i in range(n)],
        [(1 << ((i + 1) % 3)) for i in range(n)],
    )


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_random_seed_a(spec, state):
    rng = Random(31001)
    n = len(state.validators)
    yield from _run_rotation(
        spec, state,
        [rng.randrange(8) for _ in range(n)],
        [rng.randrange(8) for _ in range(n)],
    )


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_random_seed_b(spec, state):
    rng = Random(31002)
    n = len(state.validators)
    yield from _run_rotation(
        spec, state,
        [rng.randrange(8) for _ in range(n)],
        [rng.randrange(8) for _ in range(n)],
    )


@with_phases([ALTAIR])
@spec_state_test
def test_rotation_preserves_inactivity_scores(spec, state):
    # the rotation touches ONLY the two participation lists
    rng = Random(31003)
    state.inactivity_scores = [
        spec.uint64(rng.randrange(50)) for _ in range(len(state.validators))
    ]
    before = [int(s) for s in state.inactivity_scores]
    n = len(state.validators)
    yield from _run_rotation(
        spec, state,
        [rng.randrange(8) for _ in range(n)],
        [rng.randrange(8) for _ in range(n)],
    )
    assert [int(s) for s in state.inactivity_scores] == before
