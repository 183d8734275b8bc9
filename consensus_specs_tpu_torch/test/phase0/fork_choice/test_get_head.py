"""get_head integration tests — LMD-GHOST head over fed events
(spec: reference specs/phase0/fork-choice.md:221-235; scenario coverage
modeled on the reference's phase0/fork_choice suite, written for this
harness)."""
from ...context import (
    MINIMAL, spec_state_test, with_all_phases, with_presets,
)
from ...helpers.attestations import get_valid_attestation
from ...helpers.block import build_empty_block_for_next_slot
from ...helpers.fork_choice import (
    add_attestation,
    apply_next_epoch_with_attestations,
    get_anchor_parts,
    get_genesis_forkchoice_store_and_block,
    tick_and_add_block,
    tick_to_slot,
)
from ...helpers.state import next_epoch, state_transition_and_sign_block


@with_all_phases
@spec_state_test
def test_genesis_head(spec, state):
    anchor_state, anchor_block = get_anchor_parts(spec, state)
    yield 'anchor_state', anchor_state
    yield 'anchor_block', anchor_block
    store, genesis_block = get_genesis_forkchoice_store_and_block(spec, state)
    assert spec.get_head(store) == spec.hash_tree_root(genesis_block)


@with_all_phases
@spec_state_test
def test_chain_no_attestations(spec, state):
    test_steps = []
    store, genesis_block = get_genesis_forkchoice_store_and_block(spec, state)
    assert spec.get_head(store) == spec.hash_tree_root(genesis_block)

    # two blocks in a row: head follows the chain tip without any votes
    block_1 = build_empty_block_for_next_slot(spec, state)
    signed_block_1 = state_transition_and_sign_block(spec, state, block_1)
    tick_and_add_block(spec, store, signed_block_1, test_steps)

    block_2 = build_empty_block_for_next_slot(spec, state)
    signed_block_2 = state_transition_and_sign_block(spec, state, block_2)
    tick_and_add_block(spec, store, signed_block_2, test_steps)

    assert spec.get_head(store) == spec.hash_tree_root(block_2)
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_split_tie_breaker_no_attestations(spec, state):
    """Two competing children with zero votes: the lexicographically greater
    root wins (fork-choice.md:233-235 tie-break)."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    base_state = state.copy()

    state_a = base_state.copy()
    block_a = build_empty_block_for_next_slot(spec, state_a)
    block_a.body.graffiti = b'\x01' + b'\x00' * 31
    signed_a = state_transition_and_sign_block(spec, state_a, block_a)
    tick_and_add_block(spec, store, signed_a, test_steps)

    state_b = base_state.copy()
    block_b = build_empty_block_for_next_slot(spec, state_b)
    block_b.body.graffiti = b'\x02' + b'\x00' * 31
    signed_b = state_transition_and_sign_block(spec, state_b, block_b)
    tick_and_add_block(spec, store, signed_b, test_steps)

    expected = max(
        spec.hash_tree_root(block_a), spec.hash_tree_root(block_b)
    )
    assert spec.get_head(store) == expected
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_shorter_chain_but_heavier_weight(spec, state):
    """A one-block fork with a vote outweighs a longer voteless fork."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)
    base_state = state.copy()

    # long chain: 3 empty blocks
    long_state = base_state.copy()
    long_tip = None
    for _ in range(3):
        block = build_empty_block_for_next_slot(spec, long_state)
        long_tip = state_transition_and_sign_block(spec, long_state, block)
        tick_and_add_block(spec, store, long_tip, test_steps)
    assert spec.get_head(store) == spec.hash_tree_root(long_tip.message)

    # short chain: 1 block, but it gets an attestation
    short_state = base_state.copy()
    short_block = build_empty_block_for_next_slot(spec, short_state)
    short_block.body.graffiti = b'\x42' + b'\x00' * 31
    signed_short = state_transition_and_sign_block(spec, short_state, short_block)
    tick_and_add_block(spec, store, signed_short, test_steps)

    short_attestation = get_valid_attestation(
        spec, short_state, slot=short_block.slot, signed=True
    )
    # attestation affects fork choice only once its slot is in the past
    tick_to_slot(spec, store, short_attestation.data.slot + 1, test_steps)
    add_attestation(spec, store, short_attestation, test_steps)

    assert spec.get_head(store) == spec.hash_tree_root(short_block)
    yield 'steps', 'data', test_steps


@with_all_phases
@with_presets([MINIMAL], reason="epoch-scale event feeding")
@spec_state_test
def test_filtered_block_tree(spec, state):
    """Branches whose leaf disagrees with the store's justified checkpoint
    are filtered out of the head walk (fork-choice.md:168-216)."""
    test_steps = []
    store, _ = get_genesis_forkchoice_store_and_block(spec, state)

    # justify epoch 1 on the canonical chain
    for _ in range(3):
        state, _ = apply_next_epoch_with_attestations(
            spec, state, store, test_steps
        )
    assert store.justified_checkpoint.epoch > 0
    head = spec.get_head(store)

    # a fork from the PRE-justification state can't satisfy the justified
    # checkpoint; it must not win even with fresh blocks
    pre_root = store.justified_checkpoint.root
    fork_state = store.block_states[pre_root].copy()
    next_epoch(spec, fork_state)  # skip ahead, then build a competing block
    block = build_empty_block_for_next_slot(spec, fork_state)
    signed = state_transition_and_sign_block(spec, fork_state, block)
    # feeding it is valid; it just can't become head
    tick_and_add_block(spec, store, signed, test_steps)

    assert spec.get_head(store) == head
    yield 'steps', 'data', test_steps


@with_all_phases
@spec_state_test
def test_vote_moves_head_to_lighter_fork(spec, state):
    # two competing single-block forks with a no-vote tie: one attestation
    # for the tie-LOSING side must flip the head (LMD weight beats the
    # lexicographic tie-break, fork-choice.md get_latest_attesting_balance)
    test_steps = []
    store, genesis_block = get_genesis_forkchoice_store_and_block(spec, state)

    state_a = state.copy()
    state_b = state.copy()
    block_a = build_empty_block_for_next_slot(spec, state_a)
    block_a.body.graffiti = spec.Bytes32(b"\x01" * 32)
    signed_a = state_transition_and_sign_block(spec, state_a, block_a)
    block_b = build_empty_block_for_next_slot(spec, state_b)
    block_b.body.graffiti = spec.Bytes32(b"\x02" * 32)
    signed_b = state_transition_and_sign_block(spec, state_b, block_b)

    yield 'anchor_state', get_anchor_parts(spec, state)[0]
    yield 'anchor_block', get_anchor_parts(spec, state)[1]
    tick_and_add_block(spec, store, signed_a, test_steps)
    tick_and_add_block(spec, store, signed_b, test_steps)

    root_a = spec.hash_tree_root(block_a)
    root_b = spec.hash_tree_root(block_b)
    tie_head = spec.get_head(store)
    assert tie_head in (root_a, root_b)
    loser_state, loser_signed, loser_root = (
        (state_a, signed_a, root_a) if tie_head == root_b
        else (state_b, signed_b, root_b)
    )

    # one vote for the tie loser: head must flip to it
    attestation = get_valid_attestation(
        spec, loser_state, slot=loser_signed.message.slot, signed=True,
        beacon_block_root=loser_root,
    )
    # advance the store clock so the attestation's slot+1 is reached
    tick_to_slot(spec, store, loser_signed.message.slot + 1, test_steps)
    add_attestation(spec, store, attestation, test_steps)
    assert spec.get_head(store) == loser_root
    yield 'steps', 'data', test_steps
