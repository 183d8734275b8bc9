"""State-advancing helpers (reference: test/helpers/state.py)."""


def next_slot(spec, state):
    """Transition to the next slot."""
    spec.process_slots(state, state.slot + 1)


def next_slots(spec, state, slots):
    """Transition given slots forward."""
    if slots > 0:
        spec.process_slots(state, state.slot + slots)


def next_epoch(spec, state):
    """Transition to the start slot of the next epoch."""
    slot = state.slot + spec.SLOTS_PER_EPOCH - (state.slot % spec.SLOTS_PER_EPOCH)
    if slot > state.slot:
        spec.process_slots(state, slot)


def next_epoch_via_block(spec, state):
    """Transition to the start slot of the next epoch via a full block transition."""
    from .block import apply_empty_block

    return apply_empty_block(
        spec, state, state.slot + spec.SLOTS_PER_EPOCH - state.slot % spec.SLOTS_PER_EPOCH
    )


def get_balance(state, index):
    return state.balances[index]


def transition_to(spec, state, slot):
    """Transition to ``slot``."""
    assert state.slot <= slot
    for _ in range(slot - state.slot):
        next_slot(spec, state)
    assert state.slot == slot


def transition_to_slot_via_block(spec, state, slot):
    """Transition to ``slot`` via an empty block transition."""
    from .block import apply_empty_block

    assert state.slot < slot
    apply_empty_block(spec, state, slot)
    assert state.slot == slot


def get_state_root(spec, state, slot):
    """Return the state root at a recent ``slot``."""
    assert slot < state.slot <= slot + spec.SLOTS_PER_HISTORICAL_ROOT
    return state.state_roots[slot % spec.SLOTS_PER_HISTORICAL_ROOT]


def state_transition_and_sign_block(spec, state, block, expect_fail=False):
    """Mutate ``state`` through the unsigned block transition, seal the block
    with the resulting state root, and sign it."""
    from .block import sign_block, transition_unsigned_block

    transition_unsigned_block(spec, state, block)
    block.state_root = spec.hash_tree_root(state)
    return sign_block(spec, state, block)


def advance_into_leak(spec, state, extra_epochs=0):
    """Advance empty epochs until the inactivity leak is active
    (MIN_EPOCHS_TO_INACTIVITY_PENALTY + 2 + extra), asserting it engaged."""
    for _ in range(int(spec.MIN_EPOCHS_TO_INACTIVITY_PENALTY) + 2 + extra_epochs):
        next_epoch(spec, state)
    assert spec.is_in_inactivity_leak(state)
    return state
