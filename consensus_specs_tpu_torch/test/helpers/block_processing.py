"""Block-processing sub-call runner (reference: test/helpers/block_processing.py)."""


def get_process_calls(spec):
    return [
        'process_block_header',
        'process_randao',
        'process_eth1_data',
        # process_operations is split into sub-calls by the callers
        'process_proposer_slashing',
        'process_attester_slashing',
        'process_attestation',
        'process_deposit',
        'process_voluntary_exit',
        'process_sync_aggregate',  # altair
        'process_execution_payload',  # merge
    ]


def run_block_processing_to(spec, state, block, process_name):
    """Advance state to the block slot, then run block sub-processing up to
    (but not including) ``process_name``. Returns the prepared state."""
    if state.slot < block.slot:
        spec.process_slots(state, block.slot)

    for name in ['process_block_header', 'process_randao', 'process_eth1_data']:
        if name == process_name:
            return state
        getattr(spec, name)(state, block if name == 'process_block_header' else block.body)

    return state
