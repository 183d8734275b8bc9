"""Unit tests for the sharding draft's committee/shard mapping and the
EIP-1559-style sample-price update (original tests against reference
specs/sharding/beacon-chain.md:433-540; the reference's own sharding
unittest file targets a stale earlier draft and cannot run there)."""
from ...context import CUSTODY_GAME, SHARDING, spec_state_test, with_phases
from ...helpers.state import next_epoch


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_active_shard_count_bounds_committees(spec, state):
    epoch = spec.get_current_epoch(state)
    count = spec.get_committee_count_per_slot(state, epoch)
    assert 1 <= count <= spec.get_active_shard_count(state, epoch)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_get_start_shard_wraps_by_committee_count(spec, state):
    epoch = spec.get_current_epoch(state)
    committee_count = spec.get_committee_count_per_slot(state, epoch)
    active = spec.get_active_shard_count(state, epoch)
    for slot in range(int(spec.SLOTS_PER_EPOCH)):
        assert spec.get_start_shard(state, spec.Slot(slot)) == (
            committee_count * slot % active
        )


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_committee_index_roundtrip(spec, state):
    next_epoch(spec, state)
    slot = state.slot
    epoch = spec.get_current_epoch(state)
    for index in range(int(spec.get_committee_count_per_slot(state, epoch))):
        shard = spec.compute_shard_from_committee_index(
            state, slot, spec.CommitteeIndex(index)
        )
        assert shard < spec.get_active_shard_count(state, epoch)
        back = spec.compute_committee_index_from_shard(state, slot, shard)
        assert back == index


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_compute_shard_rejects_out_of_range_index(spec, state):
    epoch = spec.get_current_epoch(state)
    bad = spec.CommitteeIndex(spec.get_active_shard_count(state, epoch))
    try:
        spec.compute_shard_from_committee_index(state, state.slot, bad)
        raised = False
    except AssertionError:
        raised = True
    assert raised


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_sample_price_at_target_is_stable_or_floor_bound(spec, state):
    active = spec.get_active_shard_count(state, spec.get_current_epoch(state))
    price = spec.Gwei(1000)
    # exactly at target: the "below-or-at" branch still drains at most delta,
    # and never below the floor
    updated = spec.compute_updated_sample_price(
        price, spec.TARGET_SAMPLES_PER_BLOB, active
    )
    assert spec.MIN_SAMPLE_PRICE <= updated <= price


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_sample_price_rises_above_target_and_caps(spec, state):
    active = spec.get_active_shard_count(state, spec.get_current_epoch(state))
    price = spec.Gwei(1000)
    up = spec.compute_updated_sample_price(price, spec.MAX_SAMPLES_PER_BLOB, active)
    assert up > price
    # ceiling respected even from the top
    capped = spec.compute_updated_sample_price(
        spec.MAX_SAMPLE_PRICE, spec.MAX_SAMPLES_PER_BLOB, active
    )
    assert capped == spec.MAX_SAMPLE_PRICE


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_sample_price_falls_below_target_and_floors(spec, state):
    active = spec.get_active_shard_count(state, spec.get_current_epoch(state))
    price = spec.Gwei(1000)
    down = spec.compute_updated_sample_price(price, spec.uint64(0), active)
    assert down < price
    floored = spec.compute_updated_sample_price(
        spec.MIN_SAMPLE_PRICE, spec.uint64(0), active
    )
    assert floored >= 0
    assert floored <= spec.MIN_SAMPLE_PRICE


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_committee_source_epoch_lookahead(spec, state):
    period = spec.uint64(8)
    # within the first period there is nothing to look back to
    assert spec.compute_committee_source_epoch(spec.Epoch(3), period) == 0
    # afterwards: snap to period start, then one full period back
    assert spec.compute_committee_source_epoch(spec.Epoch(8), period) == 0
    assert spec.compute_committee_source_epoch(spec.Epoch(17), period) == 8
    assert spec.compute_committee_source_epoch(spec.Epoch(24), period) == 16


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_next_power_of_two_and_previous_slot(spec, state):
    assert spec.next_power_of_two(1) == 1
    assert spec.next_power_of_two(3) == 4
    assert spec.next_power_of_two(8) == 8
    assert spec.next_power_of_two(9) == 16
    assert spec.compute_previous_slot(spec.Slot(0)) == 0
    assert spec.compute_previous_slot(spec.Slot(5)) == 4


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_proposer_is_active_validator(spec, state):
    next_epoch(spec, state)
    epoch = spec.get_current_epoch(state)
    active = spec.get_active_validator_indices(state, epoch)
    for shard in range(int(spec.get_active_shard_count(state, epoch))):
        proposer = spec.get_shard_proposer_index(state, state.slot, spec.Shard(shard))
        assert proposer in active


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_participation_flags_extended(spec, state):
    assert len(spec.PARTICIPATION_FLAG_WEIGHTS) == 4
    assert spec.PARTICIPATION_FLAG_WEIGHTS[spec.TIMELY_SHARD_FLAG_INDEX] == spec.TIMELY_SHARD_WEIGHT


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_blob_subnet_in_range_and_distinct(spec, state):
    # (reference specs/sharding/p2p-interface.md:67-78)
    next_epoch(spec, state)
    epoch = spec.get_current_epoch(state)
    committees = int(spec.get_committee_count_per_slot(state, epoch))
    start = spec.compute_start_slot_at_epoch(epoch)
    seen = set()
    for slot in range(int(start), int(start) + int(spec.SLOTS_PER_EPOCH)):
        start_shard = int(spec.get_start_shard(state, spec.Slot(slot)))
        active = int(spec.get_active_shard_count(state, epoch))
        for i in range(committees):
            shard = spec.Shard((start_shard + i) % active)
            subnet = spec.compute_subnet_for_shard_blob(state, spec.Slot(slot), shard)
            assert 0 <= int(subnet) < spec.SHARD_BLOB_SUBNET_COUNT
            seen.add((slot, int(shard), int(subnet)))
    # each (slot, shard) of the epoch has a deterministic subnet; with
    # committees*slots <= subnet count the mapping is collision-free
    if committees * int(spec.SLOTS_PER_EPOCH) <= int(spec.SHARD_BLOB_SUBNET_COUNT):
        assert len({sub for (_, _, sub) in seen}) == len(seen)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_blob_subnet_rejects_uncovered_shard(spec, state):
    next_epoch(spec, state)
    epoch = spec.get_current_epoch(state)
    committees = int(spec.get_committee_count_per_slot(state, epoch))
    active = int(spec.get_active_shard_count(state, epoch))
    if committees >= active:
        import pytest
        pytest.skip("every shard has a committee in this configuration")
    slot = state.slot
    uncovered = spec.Shard((int(spec.get_start_shard(state, slot)) + committees) % active)
    try:
        spec.compute_subnet_for_shard_blob(state, slot, uncovered)
        raised = False
    except AssertionError:
        raised = True
    assert raised
