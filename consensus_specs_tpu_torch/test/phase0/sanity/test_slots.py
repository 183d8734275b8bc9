"""Sanity suite for the empty-slot transition (process_slots).

Every case runs the same vector shape — pre state, a `slots` meta count,
post state — through one shared runner, then asserts on what the slot
machinery is supposed to maintain: the circular state/block-root buffers,
the deferred state_root fill-in of the cached header, and the historical
accumulator. Scenario coverage mirrors the reference sanity/slots suite;
the runner and the buffer/header assertions are this repo's own.
"""
from ...context import spec_state_test, with_all_phases
from ...helpers.state import get_state_root


def advance(spec, state, slots):
    """Vector-emitting runner: tick ``slots`` empty slots, then verify the
    bookkeeping process_slot does on the way (cached-root buffers + the
    latest_block_header state_root backfill)."""
    start_slot = state.slot
    start_root = spec.hash_tree_root(state)

    yield "pre", state
    yield "slots", "meta", int(slots)
    spec.process_slots(state, start_slot + slots)
    yield "post", state

    assert state.slot == start_slot + slots
    # the pre-state's root was snapshotted into the circular buffer at the
    # first tick (process_slot: state_roots[slot % SLOTS_PER_HISTORICAL_ROOT])
    assert get_state_root(spec, state, start_slot) == start_root
    # an empty header's state_root was backfilled at the first tick too
    assert state.latest_block_header.state_root != spec.Root()


@with_all_phases
@spec_state_test
def test_slots_1(spec, state):
    yield from advance(spec, state, 1)


@with_all_phases
@spec_state_test
def test_slots_2(spec, state):
    yield from advance(spec, state, 2)


@with_all_phases
@spec_state_test
def test_empty_epoch(spec, state):
    yield from advance(spec, state, spec.SLOTS_PER_EPOCH)


@with_all_phases
@spec_state_test
def test_double_empty_epoch(spec, state):
    yield from advance(spec, state, spec.SLOTS_PER_EPOCH * 2)


@with_all_phases
@spec_state_test
def test_over_epoch_boundary(spec, state):
    # start mid-epoch so the advance crosses the boundary off-phase
    if spec.SLOTS_PER_EPOCH > 1:
        spec.process_slots(state, state.slot + spec.SLOTS_PER_EPOCH // 2)
    yield from advance(spec, state, spec.SLOTS_PER_EPOCH)


@with_all_phases
@spec_state_test
def test_historical_accumulator(spec, state):
    # a full SLOTS_PER_HISTORICAL_ROOT span batches the root buffers into
    # exactly one new historical_roots entry
    accumulated = len(state.historical_roots)
    yield from advance(spec, state, spec.SLOTS_PER_HISTORICAL_ROOT)
    assert len(state.historical_roots) == accumulated + 1


@with_all_phases
@spec_state_test
def test_state_root_buffer_wraps(spec, state):
    # one slot PAST the buffer span: the snapshot taken at the start slot
    # has been overwritten by the wrap-around — get_state_root must now
    # look at a DIFFERENT slot's root in that cell
    span = spec.SLOTS_PER_HISTORICAL_ROOT
    start_slot = state.slot
    start_root = spec.hash_tree_root(state)
    yield "pre", state
    yield "slots", "meta", int(span + 1)
    spec.process_slots(state, start_slot + span + 1)
    yield "post", state
    overwritten = state.state_roots[start_slot % span]
    assert overwritten != start_root
