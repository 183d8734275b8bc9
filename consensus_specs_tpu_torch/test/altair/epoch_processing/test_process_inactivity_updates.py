"""process_inactivity_updates tests
(spec: reference specs/altair/beacon-chain.md:603-622)."""
from ...context import ALTAIR, spec_state_test, with_phases
from ...helpers.attestations import next_epoch_with_attestations
from ...helpers.epoch_processing import run_epoch_processing_with
from ...helpers.state import next_epoch


@with_phases([ALTAIR])
@spec_state_test
def test_genesis_epoch_no_op(spec, state):
    assert spec.get_current_epoch(state) == spec.GENESIS_EPOCH
    state.inactivity_scores = [spec.uint64(7)] * len(state.validators)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    # genesis epoch: untouched
    assert all(int(s) == 7 for s in state.inactivity_scores)


@with_phases([ALTAIR])
@spec_state_test
def test_all_inactive_scores_rise(spec, state):
    # nobody attests: every eligible validator's score += INACTIVITY_SCORE_BIAS,
    # then -= min(RATE, score) since there is no leak this early
    next_epoch(spec, state)
    next_epoch(spec, state)
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    rate = int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE)
    state.inactivity_scores = [spec.uint64(100)] * len(state.validators)
    in_leak = spec.is_in_inactivity_leak(state)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    expected = 100 + bias - (0 if in_leak else min(rate, 100 + bias))
    for index in spec.get_eligible_validator_indices(state):
        assert int(state.inactivity_scores[index]) == expected


@with_phases([ALTAIR])
@spec_state_test
def test_full_participation_scores_drop(spec, state):
    # everyone attests with timely target: score -= min(1, score), then the
    # leak-free recovery subtracts min(RATE, score)
    state, _, post = next_epoch_with_attestations(spec, state, True, False)
    state = post
    rate = int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE)
    state.inactivity_scores = [spec.uint64(50)] * len(state.validators)
    participating = spec.get_unslashed_participating_indices(
        state, spec.TIMELY_TARGET_FLAG_INDEX, spec.get_previous_epoch(state)
    )
    assert len(participating) > 0
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    for index in participating:
        assert int(state.inactivity_scores[index]) == 50 - 1 - min(rate, 49)


def _set_leaking(spec, state):
    """Force an inactivity leak: stale finality beyond
    MIN_EPOCHS_TO_INACTIVITY_PENALTY."""
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 3):
        next_epoch(spec, state)
    assert spec.is_in_inactivity_leak(state)


@with_phases([ALTAIR])
@spec_state_test
def test_leak_blocks_recovery(spec, state):
    # in a leak, the recovery-rate subtraction is withheld: non-participants
    # gain the full bias
    _set_leaking(spec, state)
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    state.inactivity_scores = [spec.uint64(40)] * len(state.validators)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    for index in spec.get_eligible_validator_indices(state):
        assert int(state.inactivity_scores[index]) == 40 + bias


@with_phases([ALTAIR])
@spec_state_test
def test_leak_participants_hold_score(spec, state):
    # participants in a leak: -= min(1, score) and NO recovery subtraction.
    # Hand a MINORITY timely-target credit so justification cannot catch up
    # and clear the leak before the inactivity pass runs.
    _set_leaking(spec, state)
    participants = list(range(0, len(state.validators), 4))
    for i in participants:
        state.previous_epoch_participation[i] = spec.add_flag(
            state.previous_epoch_participation[i], spec.TIMELY_TARGET_FLAG_INDEX
        )
    state.inactivity_scores = [spec.uint64(10)] * len(state.validators)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    assert spec.is_in_inactivity_leak(state)
    eligible = set(spec.get_eligible_validator_indices(state))
    for i in participants:
        if i in eligible:
            assert int(state.inactivity_scores[i]) == 9


@with_phases([ALTAIR])
@spec_state_test
def test_zero_scores_stay_zero_for_participants(spec, state):
    state, _, post = next_epoch_with_attestations(spec, state, True, False)
    state = post
    state.inactivity_scores = [spec.uint64(0)] * len(state.validators)
    participating = spec.get_unslashed_participating_indices(
        state, spec.TIMELY_TARGET_FLAG_INDEX, spec.get_previous_epoch(state)
    )
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    for index in participating:
        assert int(state.inactivity_scores[index]) == 0


@with_phases([ALTAIR])
@spec_state_test
def test_slashed_validator_treated_as_non_participant(spec, state):
    # a slashed validator is excluded from the unslashed-participant set even
    # with timely-target flags: its score rises by the bias
    state, _, post = next_epoch_with_attestations(spec, state, True, False)
    state = post
    participating = sorted(spec.get_unslashed_participating_indices(
        state, spec.TIMELY_TARGET_FLAG_INDEX, spec.get_previous_epoch(state)
    ))
    victim = participating[0]
    state.validators[victim].slashed = True
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    rate = int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE)
    state.inactivity_scores = [spec.uint64(100)] * len(state.validators)
    in_leak = spec.is_in_inactivity_leak(state)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    expected = 100 + bias - (0 if in_leak else min(rate, 100 + bias))
    assert int(state.inactivity_scores[victim]) == expected


@with_phases([ALTAIR])
@spec_state_test
def test_mixed_scores_follow_exact_rule(spec, state):
    # half the committee attests: verify the update rule validator by
    # validator against a python re-derivation
    state, _, post = next_epoch_with_attestations(spec, state, True, False)
    state = post
    state.inactivity_scores = [
        spec.uint64((i * 37) % 23) for i in range(len(state.validators))
    ]
    pre_scores = [int(s) for s in state.inactivity_scores]
    participating = set(spec.get_unslashed_participating_indices(
        state, spec.TIMELY_TARGET_FLAG_INDEX, spec.get_previous_epoch(state)
    ))
    eligible = list(spec.get_eligible_validator_indices(state))
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    rate = int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE)
    in_leak = spec.is_in_inactivity_leak(state)

    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')

    for index in eligible:
        score = pre_scores[index]
        if index in participating:
            score -= min(1, score)
        else:
            score += bias
        if not in_leak:
            score -= min(rate, score)
        assert int(state.inactivity_scores[index]) == score


# -- (scores x participation x leak) matrix cells ----------------------------
# Exact-value oracle: expected scores are recomputed per validator from the
# update rule (reference specs/altair/beacon-chain.md:607-622) using the
# state BEFORE the handler runs; every cell asserts all scores, not samples.

from random import Random

from ...context import spec_test, with_custom_state
from ...context import misc_balances


def _expected_scores(spec, state):
    eligible = set(spec.get_eligible_validator_indices(state))
    timely = spec.get_unslashed_participating_indices(
        state, spec.TIMELY_TARGET_FLAG_INDEX, spec.get_previous_epoch(state)
    )
    bias = int(spec.config.INACTIVITY_SCORE_BIAS)
    rate = int(spec.config.INACTIVITY_SCORE_RECOVERY_RATE)
    leaking = spec.is_in_inactivity_leak(state)
    out = []
    for i, s in enumerate(state.inactivity_scores):
        s = int(s)
        if i in eligible:
            if i in timely:
                s -= min(1, s)
            else:
                s += bias
            if not leaking:
                s -= min(rate, s)
        out.append(s)
    return out


def _seed_scores(spec, state, kind, rng):
    n = len(state.validators)
    if kind == "zero":
        state.inactivity_scores = [spec.uint64(0)] * n
    else:
        state.inactivity_scores = [
            spec.uint64(rng.randrange(0, 100)) for _ in range(n)
        ]


def _seed_participation(spec, state, kind, rng):
    n = len(state.validators)
    if kind == "empty":
        flags = [0] * n
    elif kind == "full":
        full = 0
        for f in (spec.TIMELY_SOURCE_FLAG_INDEX, spec.TIMELY_TARGET_FLAG_INDEX,
                  spec.TIMELY_HEAD_FLAG_INDEX):
            full |= 1 << int(f)
        flags = [full] * n
    else:
        flags = [rng.randrange(8) for _ in range(n)]
    state.previous_epoch_participation = [spec.ParticipationFlags(f) for f in flags]


def _run_matrix_cell(spec, state, scores, participation, leaking, seed):
    rng = Random(seed)
    if leaking:
        _set_leaking(spec, state)
    else:
        next_epoch(spec, state)
        next_epoch(spec, state)
    _seed_scores(spec, state, scores, rng)
    _seed_participation(spec, state, participation, rng)
    expected = _expected_scores(spec, state)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    assert [int(s) for s in state.inactivity_scores] == expected


@with_phases([ALTAIR])
@spec_state_test
def test_zero_scores_empty_participation(spec, state):
    yield from _run_matrix_cell(spec, state, "zero", "empty", False, 100)


@with_phases([ALTAIR])
@spec_state_test
def test_zero_scores_empty_participation_leaking(spec, state):
    yield from _run_matrix_cell(spec, state, "zero", "empty", True, 101)


@with_phases([ALTAIR])
@spec_state_test
def test_zero_scores_random_participation(spec, state):
    yield from _run_matrix_cell(spec, state, "zero", "random", False, 102)


@with_phases([ALTAIR])
@spec_state_test
def test_zero_scores_random_participation_leaking(spec, state):
    yield from _run_matrix_cell(spec, state, "zero", "random", True, 103)


@with_phases([ALTAIR])
@spec_state_test
def test_zero_scores_full_participation_leaking(spec, state):
    yield from _run_matrix_cell(spec, state, "zero", "full", True, 104)


@with_phases([ALTAIR])
@spec_state_test
def test_random_scores_empty_participation(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "empty", False, 105)


@with_phases([ALTAIR])
@spec_state_test
def test_random_scores_empty_participation_leaking(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "empty", True, 106)


@with_phases([ALTAIR])
@spec_state_test
def test_random_scores_random_participation(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "random", False, 107)


@with_phases([ALTAIR])
@spec_state_test
def test_random_scores_random_participation_leaking(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "random", True, 108)


@with_phases([ALTAIR])
@spec_state_test
def test_random_scores_full_participation(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "full", False, 109)


@with_phases([ALTAIR])
@spec_state_test
def test_random_scores_full_participation_leaking(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "full", True, 110)


@with_phases([ALTAIR])
@spec_state_test
def test_some_slashed_random_participation_leaking(spec, state):
    rng = Random(111)
    _set_leaking(spec, state)
    for i in range(0, len(state.validators), 3):
        state.validators[i].slashed = True
    _seed_scores(spec, state, "random", rng)
    _seed_participation(spec, state, "random", rng)
    expected = _expected_scores(spec, state)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    assert [int(s) for s in state.inactivity_scores] == expected


@with_phases([ALTAIR])
@spec_state_test
def test_some_exited_random_participation_leaking(spec, state):
    rng = Random(112)
    _set_leaking(spec, state)
    cur = spec.get_current_epoch(state)
    for i in range(0, len(state.validators), 4):
        state.validators[i].exit_epoch = cur  # no longer active next epoch
        state.validators[i].withdrawable_epoch = cur + 10
    _seed_scores(spec, state, "random", rng)
    _seed_participation(spec, state, "random", rng)
    expected = _expected_scores(spec, state)
    yield from run_epoch_processing_with(spec, state, 'process_inactivity_updates')
    assert [int(s) for s in state.inactivity_scores] == expected


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=misc_balances, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_misc_balances_random_matrix_cell(spec, state):
    yield from _run_matrix_cell(spec, state, "random", "random", False, 113)
