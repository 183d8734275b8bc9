"""Merge sanity: execution payloads through the FULL state transition
(spec: reference specs/merge/beacon-chain.md:253-269)."""
from ...context import MERGE, spec_state_test, with_phases
from ...helpers.block import build_empty_block_for_next_slot
from ...helpers.execution_payload import (
    build_empty_execution_payload,
    build_state_with_complete_transition,
    build_state_with_incomplete_transition,
)
from ...helpers.state import state_transition_and_sign_block


def _block_with_payload(spec, state):
    """A next-slot block carrying a payload consistent with the advanced
    state (payload fields depend on the post-slot randao mix + timestamp)."""
    block = build_empty_block_for_next_slot(spec, state)
    tmp = state.copy()
    spec.process_slots(tmp, block.slot)
    block.body.execution_payload = build_empty_execution_payload(spec, tmp)
    return block


@with_phases([MERGE])
@spec_state_test
def test_block_with_payload_post_merge(spec, state):
    build_state_with_complete_transition(spec, state)
    yield 'pre', state
    block = _block_with_payload(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert spec.is_merge_complete(state)
    assert (
        state.latest_execution_payload_header.block_hash
        == block.body.execution_payload.block_hash
    )


@with_phases([MERGE])
@spec_state_test
def test_merge_transition_block(spec, state):
    # pre-merge state; the first block with a non-empty payload IS the merge
    build_state_with_incomplete_transition(spec, state)
    assert not spec.is_merge_complete(state)
    yield 'pre', state
    block = _block_with_payload(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    yield 'blocks', [signed_block]
    yield 'post', state
    assert spec.is_merge_complete(state)


@with_phases([MERGE])
@spec_state_test
def test_pre_merge_empty_payload_chain(spec, state):
    # before the merge, blocks with the default (empty) payload skip
    # execution processing entirely
    build_state_with_incomplete_transition(spec, state)
    yield 'pre', state
    blocks = []
    for _ in range(3):
        block = build_empty_block_for_next_slot(spec, state)
        blocks.append(state_transition_and_sign_block(spec, state, block))
    yield 'blocks', blocks
    yield 'post', state
    assert not spec.is_merge_complete(state)
