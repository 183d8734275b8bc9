"""process_sync_committee_updates tests
(spec: reference specs/altair/beacon-chain.md:669-679)."""
from ...context import ALTAIR, MINIMAL, spec_state_test, with_phases, with_presets
from ...helpers.epoch_processing import run_epoch_processing_with
from ...helpers.state import transition_to


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_sync_committees_progress_at_period_boundary(spec, state):
    # move to the last epoch of the first sync-committee period
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    transition_to(
        spec, state, (period_epochs - 1) * spec.SLOTS_PER_EPOCH
    )
    pre_current = state.current_sync_committee.copy()
    pre_next = state.next_sync_committee.copy()

    yield from run_epoch_processing_with(spec, state, 'process_sync_committee_updates')

    # rotation: next becomes current, a freshly computed committee fills next
    assert state.current_sync_committee == pre_next
    assert state.next_sync_committee == spec.get_next_sync_committee(state)
    _ = pre_current  # superseded


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_sync_committees_no_progress_mid_period(spec, state):
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    assert period_epochs > 2
    transition_to(spec, state, spec.SLOTS_PER_EPOCH)  # epoch 1, mid-period
    pre_current = state.current_sync_committee.copy()
    pre_next = state.next_sync_committee.copy()

    yield from run_epoch_processing_with(spec, state, 'process_sync_committee_updates')

    assert state.current_sync_committee == pre_current
    assert state.next_sync_committee == pre_next


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_sync_committees_rotate_after_registry_churn(spec, state):
    # exits + balance churn between the committees' computation and the
    # period boundary: the NEW next committee is computed from the mutated
    # registry, while current inherits the pre-computed next unchanged
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    transition_to(spec, state, (period_epochs - 1) * spec.SLOTS_PER_EPOCH)
    cur_epoch = spec.get_current_epoch(state)
    for i in range(0, len(state.validators), 5):
        # both views: the earlier effective-balance-update pass would
        # otherwise restore effective from the untouched raw balance
        state.validators[i].effective_balance = spec.EFFECTIVE_BALANCE_INCREMENT
        state.balances[i] = spec.EFFECTIVE_BALANCE_INCREMENT
    state.validators[1].exit_epoch = cur_epoch + 1
    pre_next = state.next_sync_committee.copy()

    yield from run_epoch_processing_with(spec, state, 'process_sync_committee_updates')

    assert state.current_sync_committee == pre_next
    assert state.next_sync_committee == spec.get_next_sync_committee(state)


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_sync_committees_stable_through_consecutive_boundaries(spec, state):
    # two consecutive period boundaries: each rotation promotes the
    # previously-computed next committee exactly once
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    transition_to(spec, state, (period_epochs - 1) * spec.SLOTS_PER_EPOCH)
    first_next = state.next_sync_committee.copy()
    yield from run_epoch_processing_with(spec, state, 'process_sync_committee_updates')
    assert state.current_sync_committee == first_next
    second_next = state.next_sync_committee.copy()

    # place the clock at the LAST epoch of the next period with a bare slot
    # bump and invoke the handler directly — running full epoch transitions
    # here would rotate the committee a second time at the first boundary
    # and make this assertion vacuous
    state.slot = spec.Slot((2 * period_epochs - 1) * spec.SLOTS_PER_EPOCH)
    assert (spec.get_current_epoch(state) + 1) % period_epochs == 0
    spec.process_sync_committee_updates(state)
    assert state.current_sync_committee == second_next
    assert state.next_sync_committee == spec.get_next_sync_committee(state)


@with_phases([ALTAIR])
@with_presets([MINIMAL], reason="period transition needs few epochs only on minimal")
@spec_state_test
def test_sync_committees_aggregate_pubkey_consistent(spec, state):
    # the promoted committee's precomputed aggregate_pubkey must equal the
    # aggregate of its member pubkeys (specs/altair/beacon-chain.md:279-293)
    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    transition_to(spec, state, (period_epochs - 1) * spec.SLOTS_PER_EPOCH)
    yield from run_epoch_processing_with(spec, state, 'process_sync_committee_updates')
    agg = spec.eth_aggregate_pubkeys(list(state.current_sync_committee.pubkeys))
    assert agg == state.current_sync_committee.aggregate_pubkey
