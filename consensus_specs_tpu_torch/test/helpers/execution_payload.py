"""Execution-payload builders (merge+).

Own design for this harness; fills the role of the reference's
test/helpers/execution_payload.py. The payload "chain" is synthetic: block
hashes are SSZ-root-derived stand-ins for execution-block RLP hashes (the
NoopExecutionEngine accepts anything, reference setup.py:525-540).
"""


def build_empty_execution_payload(spec, state, randao_mix=None):
    """A payload valid on top of ``state`` (state must be at the block's
    slot, i.e. after process_slots)."""
    latest = state.latest_execution_payload_header
    if randao_mix is None:
        randao_mix = spec.get_randao_mix(state, spec.get_current_epoch(state))
    payload = spec.ExecutionPayload(
        parent_hash=latest.block_hash,
        coinbase=spec.ExecutionAddress(),
        state_root=latest.state_root,  # no execution-state change
        receipt_root=b"\x42" * 32,  # no receipts
        logs_bloom=b"\x00" * int(spec.BYTES_PER_LOGS_BLOOM),
        block_number=latest.block_number + 1,
        random=randao_mix,
        gas_limit=latest.gas_limit,
        gas_used=spec.uint64(0),
        timestamp=spec.compute_timestamp_at_slot(state, state.slot),
        extra_data=b"",
        base_fee_per_gas=spec.uint256(0),
        transactions=[],
    )
    # synthetic execution-block hash over the payload's own content
    payload.block_hash = spec.Hash32(
        spec.hash(payload.hash_tree_root() + b"FAKE RLP HASH")
    )
    return payload


def get_execution_payload_header(spec, payload):
    return spec.ExecutionPayloadHeader(
        parent_hash=payload.parent_hash,
        coinbase=payload.coinbase,
        state_root=payload.state_root,
        receipt_root=payload.receipt_root,
        logs_bloom=payload.logs_bloom,
        random=payload.random,
        block_number=payload.block_number,
        gas_limit=payload.gas_limit,
        gas_used=payload.gas_used,
        timestamp=payload.timestamp,
        extra_data=payload.extra_data,
        base_fee_per_gas=payload.base_fee_per_gas,
        block_hash=payload.block_hash,
        transactions_root=spec.hash_tree_root(payload.transactions),
    )


def build_state_with_complete_transition(spec, state):
    """Give ``state`` a non-empty latest payload header: the merge is done."""
    pre_header = spec.ExecutionPayloadHeader(
        block_hash=b"\x11" * 32,
        parent_hash=b"\x10" * 32,
        gas_limit=spec.uint64(30_000_000),
        block_number=spec.uint64(100),
    )
    state.latest_execution_payload_header = pre_header
    assert spec.is_merge_complete(state)
    return state


def build_state_with_incomplete_transition(spec, state):
    state.latest_execution_payload_header = spec.ExecutionPayloadHeader()
    assert not spec.is_merge_complete(state)
    return state
