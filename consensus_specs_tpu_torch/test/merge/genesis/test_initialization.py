"""Merge genesis initialization (original; reference
merge/genesis/test_initialization.py scenario space; spec
specs/merge/beacon-chain.md:335-382)."""
from ...context import MERGE, MINIMAL, spec_test, with_phases, with_presets
from ...phase0.genesis.test_genesis import prepare_full_genesis_deposits


def _genesis_inputs(spec):
    deposit_count = spec.config.MIN_GENESIS_ACTIVE_VALIDATOR_COUNT
    deposits, _, _ = prepare_full_genesis_deposits(
        spec, spec.MAX_EFFECTIVE_BALANCE, deposit_count, signed=True
    )
    return b'\x12' * 32, spec.config.MIN_GENESIS_TIME, deposits


@with_phases([MERGE])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_initialize_pre_transition(spec):
    eth1_block_hash, eth1_timestamp, deposits = _genesis_inputs(spec)
    yield 'eth1_block_hash', 'bytes', eth1_block_hash
    yield 'eth1_timestamp', 'meta', int(eth1_timestamp)
    state = spec.initialize_beacon_state_from_eth1(
        eth1_block_hash, eth1_timestamp, deposits
    )
    assert state.fork.current_version == spec.config.MERGE_FORK_VERSION
    assert state.fork.previous_version == spec.config.MERGE_FORK_VERSION
    # empty payload header: the merge has not happened on this chain yet
    assert not spec.is_merge_complete(state)
    assert spec.is_valid_genesis_state(state)
    yield 'state', state


@with_phases([MERGE])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_initialize_post_transition(spec):
    eth1_block_hash, eth1_timestamp, deposits = _genesis_inputs(spec)
    header = spec.ExecutionPayloadHeader(
        block_hash=b'\x33' * 32,
        parent_hash=b'\x32' * 32,
        gas_limit=spec.uint64(30_000_000),
        block_number=spec.uint64(1),
    )
    yield 'eth1_block_hash', 'bytes', eth1_block_hash
    yield 'eth1_timestamp', 'meta', int(eth1_timestamp)
    yield 'execution_payload_header', header
    state = spec.initialize_beacon_state_from_eth1(
        eth1_block_hash, eth1_timestamp, deposits,
        execution_payload_header=header,
    )
    assert spec.is_merge_complete(state)
    assert state.latest_execution_payload_header == header
    yield 'state', state


@with_phases([MERGE])
@with_presets([MINIMAL], reason="too slow")
@spec_test
def test_initialize_sync_committees_filled(spec):
    eth1_block_hash, eth1_timestamp, deposits = _genesis_inputs(spec)
    yield 'eth1_block_hash', 'bytes', eth1_block_hash
    yield 'eth1_timestamp', 'meta', int(eth1_timestamp)
    state = spec.initialize_beacon_state_from_eth1(
        eth1_block_hash, eth1_timestamp, deposits
    )
    # altair machinery carried through the merge genesis
    assert state.current_sync_committee == spec.get_next_sync_committee(state)
    assert len(state.inactivity_scores) == len(state.validators)
    yield 'state', state
