"""Merge transition predicates (scenario space of the reference's
merge/unittests/test_transition.py; spec
specs/merge/beacon-chain.md:193-213)."""
from ...context import MERGE, spec_state_test, with_phases
from ...helpers.execution_payload import (
    build_empty_execution_payload,
    build_state_with_complete_transition,
    build_state_with_incomplete_transition,
)
from ...helpers.state import next_slot


@with_phases([MERGE])
@spec_state_test
def test_is_merge_complete_tracks_header(spec, state):
    build_state_with_incomplete_transition(spec, state)
    assert not spec.is_merge_complete(state)
    build_state_with_complete_transition(spec, state)
    assert spec.is_merge_complete(state)


@with_phases([MERGE])
@spec_state_test
def test_is_merge_block_only_at_transition(spec, state):
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    body = spec.BeaconBlockBody()
    # empty payload on an incomplete chain: not the merge block
    assert not spec.is_merge_block(state, body)
    body.execution_payload = build_empty_execution_payload(spec, state)
    assert spec.is_merge_block(state, body)
    # once complete, nothing is "the" merge block anymore
    build_state_with_complete_transition(spec, state)
    assert not spec.is_merge_block(state, body)


@with_phases([MERGE])
@spec_state_test
def test_is_execution_enabled_either_way(spec, state):
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    body = spec.BeaconBlockBody()
    assert not spec.is_execution_enabled(state, body)
    body.execution_payload = build_empty_execution_payload(spec, state)
    assert spec.is_execution_enabled(state, body)  # merge block
    empty_body = spec.BeaconBlockBody()
    build_state_with_complete_transition(spec, state)
    assert spec.is_execution_enabled(state, empty_body)  # merge complete


@with_phases([MERGE])
@spec_state_test
def test_compute_timestamp_at_slot_linear(spec, state):
    t0 = spec.compute_timestamp_at_slot(state, spec.Slot(0))
    assert t0 == state.genesis_time
    t5 = spec.compute_timestamp_at_slot(state, spec.Slot(5))
    assert t5 == state.genesis_time + 5 * spec.config.SECONDS_PER_SLOT
