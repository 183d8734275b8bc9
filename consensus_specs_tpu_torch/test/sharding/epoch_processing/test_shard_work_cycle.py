"""Epoch-boundary shard-work lifecycle: stale-header resolution and the
pending-work reset (original; reference
specs/sharding/beacon-chain.md:832-888)."""
from ...context import CUSTODY_GAME, SHARDING, spec_state_test, with_phases
from ...helpers.attestations import get_valid_attestation
from ...helpers.epoch_processing import run_epoch_processing_to, run_epoch_processing_with
from ...helpers.shard_blob import build_shard_blob_header
from ...helpers.state import next_epoch, next_slot


def _armed_state(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)


def _work(spec, state, slot, shard):
    return state.shard_buffer[int(slot) % int(spec.SHARD_STATE_MEMORY_SLOTS)][int(shard)]


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_reset_pending_shard_work_arms_next_epoch(spec, state):
    yield from run_epoch_processing_with(spec, state, 'reset_pending_shard_work')

    next_epoch_start = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state) + 1)
    committees = int(spec.get_committee_count_per_slot(state, spec.get_current_epoch(state) + 1))
    active = int(spec.get_active_shard_count(state, spec.get_current_epoch(state) + 1))
    for slot in range(int(next_epoch_start), int(next_epoch_start) + int(spec.SLOTS_PER_EPOCH)):
        start_shard = int(spec.get_start_shard(state, spec.Slot(slot)))
        armed = {(start_shard + i) % active for i in range(committees)}
        for shard in range(active):
            work = _work(spec, state, slot, shard)
            if shard in armed:
                assert work.status.selector == spec.SHARD_WORK_PENDING
                headers = work.status.value
                assert len(headers) == 1  # the default "empty" header
                assert headers[0].attested == spec.AttestedDataCommitment()
                assert headers[0].update_slot == slot
            else:
                assert work.status.selector == spec.SHARD_WORK_UNCONFIRMED


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_stale_unvoted_epoch_resolves_unconfirmed(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_PENDING

    # during process_epoch at the N->N+1 boundary the "previous epoch" is
    # N-1, so slot's work resolves at the SECOND boundary after arming
    next_epoch(spec, state)
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_PENDING

    # the previous epoch's pending work (only the default empty header,
    # weight 0) must nullify
    yield from run_epoch_processing_with(spec, state, 'process_pending_shard_confirmations')
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_UNCONFIRMED


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_stale_voted_header_wins_confirmation(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    signed = build_shard_blob_header(spec, state, slot=slot, shard=0)
    spec.process_shard_header(state, signed)
    header_root = spec.hash_tree_root(signed.message)

    # a below-threshold vote: not enough for expedited confirmation, but the
    # heaviest pending header at the epoch boundary (signed AFTER the vote
    # is set so real-BLS runs verify)
    from ...helpers.attestations import sign_attestation

    attestation = get_valid_attestation(
        spec, state, slot=slot, index=0,
        filter_participant_set=lambda s: set(list(sorted(s))[:1]),
    )
    attestation.data.shard_blob_root = header_root
    sign_attestation(spec, state, attestation)
    spec.process_attestation(state, attestation)
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_PENDING

    # survive the first boundary (it resolves the epoch before ours), then
    # run the resolving pass at the second
    next_epoch(spec, state)
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_PENDING
    run_epoch_processing_to(spec, state, 'process_pending_shard_confirmations')
    spec.process_pending_shard_confirmations(state)

    work = _work(spec, state, slot, 0)
    assert work.status.selector == spec.SHARD_WORK_CONFIRMED
    assert work.status.value.root == header_root


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_genesis_epoch_skips_confirmations(spec, state):
    # at GENESIS_EPOCH there is no prior epoch to resolve — the pass is a no-op
    assert spec.get_current_epoch(state) == spec.GENESIS_EPOCH
    pre = state.shard_buffer.copy()
    spec.process_pending_shard_confirmations(state)
    assert state.shard_buffer == pre


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_full_epoch_transition_keeps_ring_buffer_consistent(spec, state):
    # three epoch transitions: every currently-armed slot is pending, and the
    # fee-market price field never leaves its [MIN, MAX] envelope
    for _ in range(3):
        next_epoch(spec, state)
        assert spec.MIN_SAMPLE_PRICE <= state.shard_sample_price <= spec.MAX_SAMPLE_PRICE
    current_start = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))
    committees = int(spec.get_committee_count_per_slot(state, spec.get_current_epoch(state)))
    active = int(spec.get_active_shard_count(state, spec.get_current_epoch(state)))
    for slot in range(int(current_start), int(current_start) + int(spec.SLOTS_PER_EPOCH)):
        start_shard = int(spec.get_start_shard(state, spec.Slot(slot)))
        for i in range(committees):
            shard = (start_shard + i) % active
            assert _work(spec, state, slot, shard).status.selector == spec.SHARD_WORK_PENDING
