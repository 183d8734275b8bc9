"""on_block handler tests
(spec: reference specs/phase0/fork-choice.md:342-388; scenario coverage
modeled on the reference's phase0/fork_choice/test_on_block.py, written for
this harness)."""
from ...context import (
    MINIMAL, spec_state_test, with_all_phases, with_presets,
)
from ...helpers.block import build_empty_block, build_empty_block_for_next_slot, sign_block
from ...helpers.fork_choice import (
    add_block,
    apply_next_epoch_with_attestations,
    get_genesis_forkchoice_store_and_block,
    run_on_block,
    tick_and_add_block,
    tick_to_slot,
)
from ...helpers.state import state_transition_and_sign_block


@with_all_phases
@spec_state_test
def test_basic(spec, state):
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)

    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    tick_and_add_block(spec, store, signed_block, test_steps)
    assert store.blocks[spec.hash_tree_root(block)] == block
    assert store.block_states[spec.hash_tree_root(block)].slot == block.slot
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_future_block_invalid(spec, state):
    """Blocks from the future are not added (fork-choice.md:248-249)."""
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    # do NOT tick: store time stays at genesis while the block is for slot 1
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    run_on_block(spec, store, signed_block, valid=False)


@with_all_phases
@spec_state_test
def test_unknown_parent_invalid(spec, state):
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    signed_block.message.parent_root = b'\x99' * 32
    tick_to_slot(spec, store, block.slot, test_steps)
    run_on_block(spec, store, signed_block, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_state_transition_rejected(spec, state):
    """on_block runs the FULL state transition; a block with a wrong state
    root must be rejected (fork-choice.md:257-259)."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    block.state_root = b'\x13' * 32
    signed_block = sign_block(spec, state, block)
    tick_to_slot(spec, store, block.slot, test_steps)
    run_on_block(spec, store, signed_block, valid=False)


@with_all_phases
@with_presets([MINIMAL], reason="epoch-scale event feeding")
@spec_state_test
def test_checkpoints_update(spec, state):
    """Feeding epochs of attesting blocks moves the store's justified and
    finalized checkpoints forward (fork-choice.md:265-287)."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    state, _ = apply_next_epoch_with_attestations(
        spec, state, store, test_steps, True, False
    )
    for _ in range(3):
        state, _ = apply_next_epoch_with_attestations(
            spec, state, store, test_steps, True, True
        )
    assert store.justified_checkpoint.epoch >= 2
    assert store.finalized_checkpoint.epoch >= 1
    assert store.finalized_checkpoint == state.finalized_checkpoint
    yield 'steps', 'data', test_steps


@with_all_phases
@with_presets([MINIMAL], reason="epoch-scale event feeding")
@spec_state_test
def test_block_before_finalized_invalid(spec, state):
    """Blocks at or before the finalized slot are rejected
    (fork-choice.md:251-255)."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    pre_finality_state = state.copy()
    state, _ = apply_next_epoch_with_attestations(
        spec, state, store, test_steps, True, False
    )
    for _ in range(3):
        state, _ = apply_next_epoch_with_attestations(
            spec, state, store, test_steps, True, True
        )
    assert store.finalized_checkpoint.epoch >= 1

    # a block on a branch from before finality can no longer be added
    block = build_empty_block_for_next_slot(spec, pre_finality_state)
    signed_block = state_transition_and_sign_block(
        spec, pre_finality_state, block
    )
    run_on_block(spec, store, signed_block, valid=False)


@with_all_phases
@with_presets([MINIMAL], reason="epoch walks are cheap only on minimal")
@spec_state_test
def test_finalized_skip_slots(spec, state):
    """A block built on skipped slots far beyond the finalized checkpoint is
    still addable as long as its ancestry passes through it."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    # finalize a couple of epochs (no previous epoch to fill on the first)
    state, _ = apply_next_epoch_with_attestations(
        spec, state, store, test_steps, True, False
    )
    for _ in range(3):
        state, _ = apply_next_epoch_with_attestations(
            spec, state, store, test_steps, True, True
        )
    assert store.finalized_checkpoint.epoch > 0

    # skip several slots, then extend
    target_slot = state.slot + 5
    tick_to_slot(spec, store, target_slot + 1, test_steps)
    block = build_empty_block(spec, state, slot=target_slot)
    signed_block = state_transition_and_sign_block(spec, state, block)
    add_block(spec, store, signed_block, test_steps)
    assert spec.hash_tree_root(block) in store.blocks
    yield 'steps', 'data', test_steps


@with_all_phases
@with_presets([MINIMAL], reason="epoch walks are cheap only on minimal")
@spec_state_test
def test_justified_checkpoint_updates_on_epoch_boundary(spec, state):
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    assert store.justified_checkpoint.epoch == 0
    state, _ = apply_next_epoch_with_attestations(
        spec, state, store, test_steps, True, False
    )
    for _ in range(2):
        state, _ = apply_next_epoch_with_attestations(
            spec, state, store, test_steps, True, True
        )
    assert store.justified_checkpoint.epoch > 0
    # the store's justified state is consistent with its own chain
    justified_state = store.block_states[store.justified_checkpoint.root]
    assert justified_state.slot <= spec.compute_start_slot_at_epoch(
        store.justified_checkpoint.epoch
    )
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_same_block_twice_is_idempotent(spec, state):
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    tick_and_add_block(spec, store, signed_block, test_steps)
    pre_blocks = len(store.blocks)
    # re-delivery neither errors nor duplicates
    run_on_block(spec, store, signed_block)
    assert len(store.blocks) == pre_blocks
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_competing_forks_both_stored(spec, state):
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    fork_state = state.copy()

    block_a = build_empty_block_for_next_slot(spec, state)
    signed_a = state_transition_and_sign_block(spec, state, block_a)
    tick_and_add_block(spec, store, signed_a, test_steps)

    block_b = build_empty_block_for_next_slot(spec, fork_state)
    block_b.body.graffiti = b'\x99' * 32
    signed_b = state_transition_and_sign_block(spec, fork_state, block_b)
    add_block(spec, store, signed_b, test_steps)

    assert spec.hash_tree_root(block_a) in store.blocks
    assert spec.hash_tree_root(block_b) in store.blocks
    assert spec.hash_tree_root(block_a) != spec.hash_tree_root(block_b)
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_block_at_current_clock_slot_accepted(spec, state):
    # a block whose slot equals the store's current slot is NOT from the
    # future and must be accepted
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    block = build_empty_block_for_next_slot(spec, state)
    signed_block = state_transition_and_sign_block(spec, state, block)
    tick_to_slot(spec, store, block.slot, test_steps)
    add_block(spec, store, signed_block, test_steps)
    assert spec.hash_tree_root(block) in store.blocks
    yield 'steps', 'data', test_steps
