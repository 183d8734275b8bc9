"""Final-updates epoch sub-pass tests: eth1 reset, effective balances,
slashings reset, randao reset, historical roots, participation records
(reference: test/phase0/epoch_processing/test_process_*.py)."""
from ...context import PHASE0, spec_state_test, with_all_phases, with_phases
from ...helpers.epoch_processing import run_epoch_processing_with
from ...helpers.state import transition_to


@with_all_phases
@spec_state_test
def test_eth1_vote_no_reset(spec, state):
    assert spec.EPOCHS_PER_ETH1_VOTING_PERIOD > 1
    # skip ahead to the end of the epoch
    transition_to(spec, state, spec.SLOTS_PER_EPOCH - 1)

    for i in range(state.slot + 1):  # add a vote for each skipped slot.
        state.eth1_data_votes.append(
            spec.Eth1Data(deposit_root=b'\xaa' * 32,
                          deposit_count=state.eth1_deposit_index,
                          block_hash=b'\xbb' * 32))

    yield from run_epoch_processing_with(spec, state, 'process_eth1_data_reset')

    assert len(state.eth1_data_votes) == spec.SLOTS_PER_EPOCH


@with_all_phases
@spec_state_test
def test_eth1_vote_reset(spec, state):
    # skip ahead to the end of the voting period
    state.slot = (spec.EPOCHS_PER_ETH1_VOTING_PERIOD * spec.SLOTS_PER_EPOCH) - 1
    for i in range(state.slot + 1):  # add a vote for each skipped slot.
        state.eth1_data_votes.append(
            spec.Eth1Data(deposit_root=b'\xaa' * 32,
                          deposit_count=state.eth1_deposit_index,
                          block_hash=b'\xbb' * 32))

    yield from run_epoch_processing_with(spec, state, 'process_eth1_data_reset')

    assert len(state.eth1_data_votes) == 0


@with_all_phases
@spec_state_test
def test_effective_balance_hysteresis(spec, state):
    # Prepare state up to the final-updates.
    # Then overwrite the balances, we only want to focus on the hysteresis based changes.
    from ...helpers.epoch_processing import run_epoch_processing_to

    run_epoch_processing_to(spec, state, 'process_effective_balance_updates')
    # Set some edge cases for balances
    max = spec.MAX_EFFECTIVE_BALANCE
    min = spec.config.EJECTION_BALANCE
    inc = spec.EFFECTIVE_BALANCE_INCREMENT
    div = spec.HYSTERESIS_QUOTIENT
    hys_inc = inc // div
    down = spec.HYSTERESIS_DOWNWARD_MULTIPLIER
    up = spec.HYSTERESIS_UPWARD_MULTIPLIER
    cases = [
        (max, max, max, "as-is"),
        (max, max - 1, max, "round up"),
        (max, max + 1, max, "round down"),
        (max, max - down * hys_inc, max, "lower balance, but not low enough"),
        (max, max - down * hys_inc - 1, max - inc, "lower balance, step down"),
        (max, max + (up * hys_inc) + 1, max, "already at max, as is"),
        (max - inc, max - inc - down * hys_inc - 1, max - (2 * inc), "lower balance, step down"),
        (max - inc, max + (up * hys_inc) + 1, max, "step up"),
        (max - inc, max, max - inc, "larger balance, but not high enough"),
        (max - inc, max + (up * hys_inc), max, "step up"),
        (min, 0, 0, "ejection-level balance drops to zero effective"),
    ]
    current_epoch = spec.get_current_epoch(state)
    for i, (pre_eff, bal, _, _) in enumerate(cases):
        assert spec.is_active_validator(state.validators[i], current_epoch)
        state.validators[i].effective_balance = pre_eff
        state.balances[i] = bal

    yield 'pre', state
    spec.process_effective_balance_updates(state)
    yield 'post', state

    for i, (_, _, post_eff, name) in enumerate(cases):
        assert state.validators[i].effective_balance == post_eff, name


@with_all_phases
@spec_state_test
def test_slashings_reset(spec, state):
    next_epoch = spec.get_current_epoch(state) + 1
    state.slashings[next_epoch % spec.EPOCHS_PER_SLASHINGS_VECTOR] = spec.Gwei(100)

    yield from run_epoch_processing_with(spec, state, 'process_slashings_reset')

    assert state.slashings[next_epoch % spec.EPOCHS_PER_SLASHINGS_VECTOR] == 0


@with_all_phases
@spec_state_test
def test_randao_mixes_reset(spec, state):
    current_epoch = spec.get_current_epoch(state)
    next_epoch = current_epoch + 1

    yield from run_epoch_processing_with(spec, state, 'process_randao_mixes_reset')

    assert state.randao_mixes[next_epoch % spec.EPOCHS_PER_HISTORICAL_VECTOR] == (
        spec.get_randao_mix(state, current_epoch)
    )


@with_all_phases
@spec_state_test
def test_historical_root_accumulator(spec, state):
    # skip ahead to near the end of the historical roots period (excl block before epoch processing)
    state.slot = spec.SLOTS_PER_HISTORICAL_ROOT - 1
    history_len = len(state.historical_roots)

    yield from run_epoch_processing_with(spec, state, 'process_historical_roots_update')

    assert len(state.historical_roots) == history_len + 1


@with_phases([PHASE0])
@spec_state_test
def test_updated_participation_record(spec, state):
    state.previous_epoch_attestations = [
        spec.PendingAttestation(proposer_index=100)
    ]
    current_epoch_attestations = [
        spec.PendingAttestation(proposer_index=200)
    ]
    state.current_epoch_attestations = current_epoch_attestations

    yield from run_epoch_processing_with(spec, state, 'process_participation_record_updates')

    assert state.previous_epoch_attestations == current_epoch_attestations
    assert state.current_epoch_attestations == []
