# The Merge — Honest Validator (executable spec source)
#
# Provenance: function bodies transcribed from the spec text (reference
# specs/merge/validator.md:44-175) — conformance requires identical
# semantics. Additive to phase0/altair validator sources.


class PayloadId(Bytes8):
    pass


def get_pow_block_at_terminal_total_difficulty(pow_chain: Dict[Hash32, PowBlock]) -> Optional[PowBlock]:
    # (merge/validator.md:51-62)
    # `pow_chain` abstractly represents all blocks in the PoW chain
    for block in pow_chain.values():
        parent = pow_chain[block.parent_hash]
        block_reached_ttd = block.total_difficulty >= config.TERMINAL_TOTAL_DIFFICULTY
        parent_reached_ttd = parent.total_difficulty >= config.TERMINAL_TOTAL_DIFFICULTY
        if block_reached_ttd and not parent_reached_ttd:
            return block

    return None


def get_terminal_pow_block(pow_chain: Dict[Hash32, PowBlock]) -> Optional[PowBlock]:
    # (merge/validator.md:66-76)
    if config.TERMINAL_BLOCK_HASH != Hash32():
        # Terminal block hash override takes precedence over terminal total difficulty
        if config.TERMINAL_BLOCK_HASH in pow_chain:
            return pow_chain[config.TERMINAL_BLOCK_HASH]
        else:
            return None

    return get_pow_block_at_terminal_total_difficulty(pow_chain)


def get_payload_id(parent_hash: Hash32, payload_attributes: PayloadAttributes) -> PayloadId:
    # (merge/validator.md:84-94 — plain hash, not hash_tree_root, so the
    # execution layer needs no SSZ)
    return PayloadId(
        hash(
            parent_hash
            + uint_to_bytes(payload_attributes.timestamp)
            + payload_attributes.random
            + payload_attributes.fee_recipient
        )[0:8]
    )


def prepare_execution_payload(state: BeaconState,
                              pow_chain: Dict[Hash32, PowBlock],
                              finalized_block_hash: Hash32,
                              fee_recipient: ExecutionAddress,
                              execution_engine: ExecutionEngine) -> Optional[PayloadId]:
    # (merge/validator.md:140-171)
    if not is_merge_complete(state):
        is_terminal_block_hash_set = config.TERMINAL_BLOCK_HASH != Hash32()
        is_activation_epoch_reached = (
            get_current_epoch(state) < config.TERMINAL_BLOCK_HASH_ACTIVATION_EPOCH
        )
        if is_terminal_block_hash_set and is_activation_epoch_reached:
            # Terminal block hash is set but activation epoch is not yet reached, no prepare payload call is needed
            return None

        terminal_pow_block = get_terminal_pow_block(pow_chain)
        if terminal_pow_block is None:
            # Pre-merge, no prepare payload call is needed
            return None
        # Signify merge via producing on top of the terminal PoW block
        parent_hash = terminal_pow_block.block_hash
    else:
        # Post-merge, normal payload
        parent_hash = state.latest_execution_payload_header.block_hash

    # Set the forkchoice head and initiate the payload build process
    payload_attributes = PayloadAttributes(
        timestamp=compute_timestamp_at_slot(state, state.slot),
        random=get_randao_mix(state, get_current_epoch(state)),
        fee_recipient=fee_recipient,
    )
    execution_engine.notify_forkchoice_updated(parent_hash, finalized_block_hash, payload_attributes)
    return get_payload_id(parent_hash, payload_attributes)


def get_execution_payload(payload_id: Optional[PayloadId],
                          execution_engine: ExecutionEngine) -> ExecutionPayload:
    # (merge/validator.md:175-186)
    if payload_id is None:
        # Pre-merge, empty payload
        return ExecutionPayload()
    else:
        return execution_engine.get_payload(payload_id)
