"""Altair-specific configuration invariants (original; the reference's
altair/unittests/test_config_invariants.py covers the same surface)."""
from ...context import ALTAIR, spec_state_test, with_phases


@with_phases([ALTAIR])
@spec_state_test
def test_weights(spec, state):
    # participation weights must sum exactly to the denominator
    assert (
        spec.TIMELY_SOURCE_WEIGHT
        + spec.TIMELY_TARGET_WEIGHT
        + spec.TIMELY_HEAD_WEIGHT
        + spec.SYNC_REWARD_WEIGHT
        + spec.PROPOSER_WEIGHT
    ) == spec.WEIGHT_DENOMINATOR
    assert len(spec.PARTICIPATION_FLAG_WEIGHTS) == 3
    assert spec.PARTICIPATION_FLAG_WEIGHTS[spec.TIMELY_SOURCE_FLAG_INDEX] == spec.TIMELY_SOURCE_WEIGHT
    assert spec.PARTICIPATION_FLAG_WEIGHTS[spec.TIMELY_TARGET_FLAG_INDEX] == spec.TIMELY_TARGET_WEIGHT
    assert spec.PARTICIPATION_FLAG_WEIGHTS[spec.TIMELY_HEAD_FLAG_INDEX] == spec.TIMELY_HEAD_WEIGHT


@with_phases([ALTAIR])
@spec_state_test
def test_time_and_committee_size(spec, state):
    # the sync committee must fit in the validator set's sampling assumptions
    assert spec.SYNC_COMMITTEE_SIZE > 0
    assert spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD >= 1
    # light-client supermajority arithmetic must be exact on the bitvector
    assert int(spec.SYNC_COMMITTEE_SIZE) % 4 == 0 or spec.SYNC_COMMITTEE_SIZE < 4


@with_phases([ALTAIR])
@spec_state_test
def test_inactivity_parameters(spec, state):
    assert spec.config.INACTIVITY_SCORE_BIAS > 0
    assert spec.config.INACTIVITY_SCORE_RECOVERY_RATE > 0
    # altair pins its own quotient: 3 * 2**24 on both presets
    # (presets/*/altair.yaml; reference specs/altair/beacon-chain.md:122-127)
    assert spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR == 3 * 2**24
    # leak math must divide cleanly into the score scale
    assert spec.INACTIVITY_PENALTY_QUOTIENT_ALTAIR % spec.config.INACTIVITY_SCORE_BIAS == 0


@with_phases([ALTAIR])
@spec_state_test
def test_generalized_index_constants(spec, state):
    # the hardcoded light-client gindices must match the SSZ layout
    # (reference setup.py:476-481, 634-635)
    assert spec.FINALIZED_ROOT_INDEX == spec.get_generalized_index(
        spec.BeaconState, 'finalized_checkpoint', 'root'
    )
    assert spec.NEXT_SYNC_COMMITTEE_INDEX == spec.get_generalized_index(
        spec.BeaconState, 'next_sync_committee'
    )
