"""Fork-choice test drive: store setup, event feeding, and step emission.

Own implementation for this harness; emits the same step vocabulary as the
reference's vector format (tests/formats/fork_choice/README.md — `tick` /
`block` / `attestation` / `checks`), so the same tests later feed the
fork_choice generator. The "network" is the test-authored event order; time
is a parameter via on_tick (reference helpers/fork_choice.py:28-110 fills
this role).
"""


def get_genesis_forkchoice_store_and_block(spec, genesis_state):
    assert genesis_state.slot == spec.GENESIS_SLOT
    genesis_block = spec.BeaconBlock(state_root=genesis_state.hash_tree_root())
    return spec.get_forkchoice_store(genesis_state, genesis_block), genesis_block


def get_genesis_forkchoice_store(spec, genesis_state):
    store, _ = get_genesis_forkchoice_store_and_block(spec, genesis_state)
    return store


def get_anchor_parts(spec, state):
    """(anchor_state, anchor_block) vector parts for a fork-choice case."""
    anchor_block = spec.BeaconBlock(state_root=state.hash_tree_root())
    return state, anchor_block


def slot_time(spec, store, slot):
    return store.genesis_time + int(slot) * int(spec.config.SECONDS_PER_SLOT)


def on_tick_and_append_step(spec, store, time, test_steps):
    spec.on_tick(store, spec.uint64(int(time)))
    test_steps.append({"tick": int(time)})


def tick_to_slot(spec, store, slot, test_steps):
    """Advance store time slot by slot (each boundary runs on_tick) so
    epoch-boundary justification promotion happens exactly as on a live
    clock."""
    current = spec.get_current_slot(store)
    for s in range(int(current) + 1, int(slot) + 1):
        on_tick_and_append_step(spec, store, slot_time(spec, store, s), test_steps)


def run_on_block(spec, store, signed_block, valid=True):
    from ..context import expect_assertion_error

    if not valid:
        expect_assertion_error(lambda: spec.on_block(store, signed_block))
        return
    spec.on_block(store, signed_block)
    root = signed_block.message.hash_tree_root()
    assert store.blocks[root] == signed_block.message
    # an on-chain attestation is also an on_attestation event ("from either
    # within a block or directly on the wire", fork-choice.md:393-396); this
    # is what stores the checkpoint state a later justified checkpoint's
    # LMD weight lookup needs
    for attestation in signed_block.message.body.attestations:
        spec.on_attestation(store, attestation)


def add_block(spec, store, signed_block, test_steps, valid=True):
    """Feed a block to on_block and record the step (+ the head/store checks
    the reference format attaches after each valid block)."""
    name = f"block_{signed_block.message.hash_tree_root().hex()[:16]}"
    test_steps.append({"block": name, "valid": bool(valid)})
    run_on_block(spec, store, signed_block, valid=valid)
    if valid:
        test_steps.append({
            "checks": {
                "head": get_formatted_head_output(spec, store),
                "justified_checkpoint": checkpoint_dict(store.justified_checkpoint),
                "finalized_checkpoint": checkpoint_dict(store.finalized_checkpoint),
            }
        })


def tick_and_add_block(spec, store, signed_block, test_steps, valid=True):
    """Advance time to the block's slot, then feed it."""
    block_slot = signed_block.message.slot
    if spec.get_current_slot(store) < block_slot:
        tick_to_slot(spec, store, block_slot, test_steps)
    add_block(spec, store, signed_block, test_steps, valid=valid)


def run_on_attestation(spec, store, attestation, valid=True):
    from ..context import expect_assertion_error

    if not valid:
        expect_assertion_error(lambda: spec.on_attestation(store, attestation))
        return
    spec.on_attestation(store, attestation)


def add_attestation(spec, store, attestation, test_steps, valid=True):
    test_steps.append({"attestation": "attestation", "valid": bool(valid)})
    run_on_attestation(spec, store, attestation, valid=valid)


def checkpoint_dict(checkpoint):
    return {"epoch": int(checkpoint.epoch), "root": checkpoint.root.hex()}


def get_formatted_head_output(spec, store):
    head = spec.get_head(store)
    slot = store.blocks[head].slot
    return {"slot": int(slot), "root": head.hex()}


def apply_next_epoch_with_attestations(spec, state, store, test_steps,
                                       fill_cur_epoch=True, fill_prev_epoch=False):
    """Drive a full epoch of blocks-with-attestations through the store;
    returns (post_state, last_signed_block)."""
    from .attestations import next_epoch_with_attestations

    _, signed_blocks, post_state = next_epoch_with_attestations(
        spec, state, fill_cur_epoch, fill_prev_epoch
    )
    for signed_block in signed_blocks:
        tick_and_add_block(spec, store, signed_block, test_steps)
    return post_state, signed_blocks[-1]
