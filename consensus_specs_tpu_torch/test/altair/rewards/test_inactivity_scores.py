"""Inactivity-score-sensitive reward/penalty deltas (scenario space of the
reference's altair/rewards/test_inactivity_scores.py, driven through this
harness's deltas-checking engine)."""
from random import Random

from ...context import ALTAIR, MERGE, spec_state_test, with_phases
from ...helpers.attestations import next_epoch_with_attestations
from ...helpers.rewards import run_deltas
from ...helpers.state import next_epoch

_ALTAIR_ON = [ALTAIR, MERGE]


def _attested_state(spec, state, participation_fn=None):
    next_epoch(spec, state)
    _, _, post = next_epoch_with_attestations(
        spec, state, True, False, participation_fn=participation_fn
    )
    return post


def _randomize_scores(spec, state, rng, high=False, half_zero=False):
    n = len(state.validators)
    scores = []
    for i in range(n):
        if half_zero and i % 2 == 0:
            scores.append(0)
        elif high:
            scores.append(rng.randrange(100, 100_000))
        else:
            scores.append(rng.randrange(0, 50))
    state.inactivity_scores = [spec.uint64(s) for s in scores]


def _leaking_state(spec, state):
    from ...helpers.state import advance_into_leak

    return advance_into_leak(spec, state, extra_epochs=1)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_inactivity_scores_0(spec, state):
    state = _attested_state(spec, state)
    _randomize_scores(spec, state, Random(9000))
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_inactivity_scores_1(spec, state):
    state = _attested_state(spec, state)
    _randomize_scores(spec, state, Random(9001))
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_half_zero_half_random_inactivity_scores(spec, state):
    state = _attested_state(spec, state)
    _randomize_scores(spec, state, Random(9002), half_zero=True)
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_high_inactivity_scores(spec, state):
    state = _attested_state(spec, state)
    _randomize_scores(spec, state, Random(9003), high=True)
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_inactivity_scores_leaking(spec, state):
    state = _leaking_state(spec, state)
    _randomize_scores(spec, state, Random(9004))
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_high_inactivity_scores_leaking(spec, state):
    state = _leaking_state(spec, state)
    _randomize_scores(spec, state, Random(9005), high=True)
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_half_zero_inactivity_scores_leaking_with_participation(spec, state):
    # some validators keep attesting inside the leak: their target flags
    # shield them from the inactivity penalty regardless of score
    state = _leaking_state(spec, state)
    participants = list(range(0, len(state.validators), 3))
    for i in participants:
        state.previous_epoch_participation[i] = spec.add_flag(
            state.previous_epoch_participation[i], spec.TIMELY_TARGET_FLAG_INDEX
        )
    _randomize_scores(spec, state, Random(9006), half_zero=True)
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_zero_scores_no_inactivity_penalties(spec, state):
    state = _attested_state(spec, state)
    state.inactivity_scores = [spec.uint64(0)] * len(state.validators)
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_inactivity_scores_partial_participation(spec, state):
    # only ~40% of each committee attests: deltas must remain component-exact
    rng = Random(60111)
    state = _attested_state(
        spec, state,
        participation_fn=lambda slot, idx, comm: (
            set(v for v in comm if rng.random() < 0.4)
            or {sorted(comm)[0]}  # never empty: an unsigned empty attestation is invalid
        ),
    )
    _randomize_scores(spec, state, Random(60112))
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_random_inactivity_scores_partial_participation_leaking(spec, state):
    rng = Random(60221)
    _leaking_state(spec, state)
    _, _, state = next_epoch_with_attestations(
        spec, state, False, True,
        participation_fn=lambda slot, idx, comm: (
            set(v for v in comm if rng.random() < 0.4)
            or {sorted(comm)[0]}
        ),
    )
    _randomize_scores(spec, state, Random(60222))
    assert spec.is_in_inactivity_leak(state)
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_banded_inactivity_scores_with_slashings(spec, state):
    # score bands (0 / small / huge) crossed with a slashed stripe
    state = _attested_state(spec, state)
    n = len(state.validators)
    state.inactivity_scores = [
        spec.uint64([0, 7, 10_000_000][i % 3]) for i in range(n)
    ]
    for i in range(0, n, 7):
        state.validators[i].slashed = True
    yield from run_deltas(spec, state)


@with_phases(_ALTAIR_ON)
@spec_state_test
def test_extreme_inactivity_scores_leaking(spec, state):
    # u64-scale scores during a leak: the quotient arithmetic must not
    # overflow or round differently from the component-exact engine
    _leaking_state(spec, state)
    _, _, state = next_epoch_with_attestations(spec, state, False, True)
    n = len(state.validators)
    # largest scores whose penalty numerator (effective_balance * score)
    # still fits uint64 — the spec's checked arithmetic rejects beyond
    state.inactivity_scores = [
        spec.uint64((1 << 28) + i * (1 << 10)) for i in range(n)
    ]
    assert spec.is_in_inactivity_leak(state)
    yield from run_deltas(spec, state)
