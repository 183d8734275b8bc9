"""process_block_header handler suite.

Exercises each of the header guards in turn — slot-match, ordering
against the cached latest header, proposer identity, parent-root
linkage, slashed proposer — plus the header-cache bookkeeping a valid
block leaves behind (state_root zeroed until the next slot tick).
Scenario coverage mirrors the reference handler suite
(tests/core/pyspec/eth2spec/test/phase0/block_processing/
test_process_block_header.py); bodies and the post-state assertions are
this repo's own.
"""
from ...context import expect_assertion_error, spec_state_test, with_all_phases
from ...helpers.block import build_empty_block_for_next_slot
from ...helpers.state import next_slot


def header_case(spec, state, block, valid=True, advance=True):
    """Vector-emitting runner. ``advance`` ticks the state to the block's
    expected slot first (callers that already positioned the state pass
    False). The valid path re-checks every field of the header cache the
    handler writes (spec process_block_header: latest_block_header =
    BeaconBlockHeader(..., state_root=Bytes32()))."""
    if advance:
        spec.process_slots(state, state.slot + 1)

    yield "pre", state
    yield "block", block

    if not valid:
        expect_assertion_error(lambda: spec.process_block_header(state, block))
        yield "post", None
        return

    spec.process_block_header(state, block)
    cached = state.latest_block_header
    assert cached.slot == block.slot
    assert cached.proposer_index == block.proposer_index
    assert cached.parent_root == block.parent_root
    assert cached.body_root == block.body.hash_tree_root()
    # the state root stays empty until process_slots fills it next tick
    assert cached.state_root == spec.Root()
    yield "post", state


@with_all_phases
@spec_state_test
def test_success_block_header(spec, state):
    yield from header_case(
        spec, state, build_empty_block_for_next_slot(spec, state)
    )


@with_all_phases
@spec_state_test
def test_invalid_slot_block_header(spec, state):
    # block claims a slot one past where the state will be ticked to:
    # the slot-match guard must reject it
    block = build_empty_block_for_next_slot(spec, state)
    block.slot += 1
    yield from header_case(spec, state, block, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_slot_from_past(spec, state):
    # the state advances PAST the block's slot before processing: a stale
    # block must fail the same slot-match guard from the other side
    block = build_empty_block_for_next_slot(spec, state)
    spec.process_slots(state, block.slot + 1)
    yield from header_case(spec, state, block, valid=False, advance=False)


@with_all_phases
@spec_state_test
def test_invalid_proposer_index(spec, state):
    # any index other than get_beacon_proposer_index's pick must be
    # rejected, even another active validator's
    block = build_empty_block_for_next_slot(spec, state)
    impostor = (int(block.proposer_index) + 1) % len(state.validators)
    block.proposer_index = impostor
    yield from header_case(spec, state, block, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_parent_root(spec, state):
    # parent_root must equal the hash_tree_root of the cached latest
    # header; a root that matches nothing in this chain fails the link
    block = build_empty_block_for_next_slot(spec, state)
    block.parent_root = spec.Root(b"\x12" * 32)
    yield from header_case(spec, state, block, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_multiple_blocks_single_slot(spec, state):
    # after one header lands at a slot, a CHILD block at the same slot —
    # even with a correct parent link to the first — must fail the
    # ordering guard (block.slot > latest_block_header.slot)
    first = build_empty_block_for_next_slot(spec, state)
    spec.process_slots(state, first.slot)
    spec.process_block_header(state, first)
    assert state.latest_block_header.slot == state.slot

    child = first.copy()
    child.parent_root = first.hash_tree_root()
    yield from header_case(spec, state, child, valid=False, advance=False)


@with_all_phases
@spec_state_test
def test_invalid_duplicate_slot_header(spec, state):
    # same ordering guard, unrelated second block: different content at
    # the landed slot, no parent link to the first
    block = build_empty_block_for_next_slot(spec, state)
    spec.process_slots(state, block.slot)
    spec.process_block_header(state, block)

    dup = build_empty_block_for_next_slot(spec, state.copy())
    dup.slot = block.slot
    dup.body.graffiti = b"\x09" * 32
    yield from header_case(spec, state, dup, valid=False, advance=False)


@with_all_phases
@spec_state_test
def test_proposer_slashed(spec, state):
    # find who WOULD propose next slot (on a scratch copy, so the real
    # state's randao/proposer draw is untouched), slash them, and check
    # their otherwise-valid block is refused
    scratch = state.copy()
    next_slot(spec, scratch)
    proposer = spec.get_beacon_proposer_index(scratch)
    state.validators[proposer].slashed = True

    block = build_empty_block_for_next_slot(spec, state)
    yield from header_case(spec, state, block, valid=False)
