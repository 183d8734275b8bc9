"""Multi-epoch state-machine walks, pytest-only (not vector-format
cases: these drive full transitions rather than a single pass)."""
from ...context import ALTAIR, MINIMAL, spec_state_test, with_phases, with_presets
from ...helpers.epoch_processing import run_epoch_processing_with
from ...helpers.state import next_epoch, transition_to
from random import Random


def _randomize_flags(spec, state, rng):
    n = len(state.validators)
    state.previous_epoch_participation = [
        spec.ParticipationFlags(rng.randrange(8)) for _ in range(n)
    ]
    state.current_epoch_participation = [
        spec.ParticipationFlags(rng.randrange(8)) for _ in range(n)
    ]


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_full_period_walk_rotates_through_real_pipeline(spec, state):
    # walk a whole sync-committee period through the REAL process_epoch
    # (not the isolated pass): the lookahead committee must become current
    # at the boundary, untouched by every mid-period transition
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    pre_next = state.next_sync_committee.copy()
    for _ in range(period_epochs):
        assert state.next_sync_committee == pre_next  # mid-period: untouched
        next_epoch(spec, state)
    assert state.current_sync_committee == pre_next
    # a fresh lookahead was installed at the boundary (computed on the
    # boundary state — recomputing here, one epoch later, would differ)
    assert state.next_sync_committee != pre_next


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_aggregate_pubkey_consistent_after_rotation(spec, state):
    # the precomputed aggregate_pubkey matches the member pubkeys after the
    # period rotation (altair/beacon-chain.md:279-293)
    from ....utils import bls as bls_mod

    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    transition_to(spec, state, (period_epochs - 1) * spec.SLOTS_PER_EPOCH)
    yield from run_epoch_processing_with(spec, state, 'process_sync_committee_updates')
    committee = state.current_sync_committee
    assert committee.aggregate_pubkey == spec.BLSPubkey(
        bls_mod.AggregatePKs(list(committee.pubkeys))
    )


@with_phases([ALTAIR])
@spec_state_test
def test_double_rotation_clears_everything(spec, state):
    _randomize_flags(spec, state, Random(7))
    n = len(state.validators)
    spec.process_participation_flag_updates(state)
    spec.process_participation_flag_updates(state)
    assert list(state.previous_epoch_participation) == [spec.ParticipationFlags(0)] * n
    assert list(state.current_epoch_participation) == [spec.ParticipationFlags(0)] * n


@with_phases([ALTAIR])
@spec_state_test
def test_inactivity_scores_grow_through_empty_leak_epochs(spec, state):
    from ...helpers.state import next_epoch

    # no attestations for > MIN_EPOCHS_TO_INACTIVITY_PENALTY: the leak arms
    # and scores climb for everyone
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 3):
        next_epoch(spec, state)
    assert spec.is_in_inactivity_leak(state)
    assert all(int(s) > 0 for s in state.inactivity_scores)
