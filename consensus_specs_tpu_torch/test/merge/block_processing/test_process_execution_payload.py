"""process_execution_payload tests
(spec: reference specs/merge/beacon-chain.md:273-324; scenario coverage
modeled on the reference's merge/block_processing suite, written for this
harness)."""
from ...context import MERGE, expect_assertion_error, spec_state_test, with_phases
from ...helpers.execution_payload import (
    build_empty_execution_payload,
    build_state_with_complete_transition,
    build_state_with_incomplete_transition,
)
from ...helpers.state import next_slot


def run_execution_payload_processing(spec, state, payload, valid=True,
                                     execution_engine=None):
    engine = execution_engine or spec.EXECUTION_ENGINE
    yield 'pre', state
    yield 'execution_payload', payload
    if not valid:
        expect_assertion_error(
            lambda: spec.process_execution_payload(state, payload, engine)
        )
        yield 'post', None
        return
    spec.process_execution_payload(state, payload, engine)
    # the header cached in state must mirror the payload exactly
    header = state.latest_execution_payload_header
    assert header.block_hash == payload.block_hash
    assert header.block_number == payload.block_number
    assert header.transactions_root == spec.hash_tree_root(payload.transactions)
    yield 'post', state


@with_phases([MERGE])
@spec_state_test
def test_success_first_payload(spec, state):
    # the merge-transition block: pre-state has the empty header
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_success_regular_payload(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_invalid_parent_hash(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.parent_hash = b'\x55' * 32
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_block_number(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.block_number = payload.block_number + 1
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_random(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.random = b'\x66' * 32
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_timestamp(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.timestamp = payload.timestamp + 1
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_gas_used_exceeds_limit(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.gas_used = payload.gas_limit + 1
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_gas_limit_jump(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    parent_limit = int(state.latest_execution_payload_header.gas_limit)
    payload.gas_limit = spec.uint64(
        parent_limit + parent_limit // int(spec.GAS_LIMIT_DENOMINATOR)
    )
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_first_payload_skips_gas_ancestry_checks(spec, state):
    # for the transition payload, parent_hash/number/gas checks don't apply
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.parent_hash = b'\x77' * 32
    payload.block_number = spec.uint64(999)
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_bad_execution_rejected(spec, state):
    # an engine that rejects the payload fails the block
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)

    class RejectingEngine(spec.NoopExecutionEngine):
        def execute_payload(self, execution_payload):
            return False

    yield from run_execution_payload_processing(
        spec, state, payload, valid=False, execution_engine=RejectingEngine()
    )


@with_phases([MERGE])
@spec_state_test
def test_success_payload_with_transactions(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.transactions = [
        spec.Transaction(b'\x99' * 16),
        spec.Transaction(b'\x01'),
        spec.Transaction(b'\xab' * 64),
    ]
    payload.block_hash = spec.Hash32(
        spec.hash(payload.hash_tree_root() + b"FAKE RLP HASH")
    )
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_success_max_extra_data(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.extra_data = b'\x45' * int(spec.MAX_EXTRA_DATA_BYTES)
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_success_gas_limit_upper_edge(spec, state):
    # one below the +1/1024 jump ceiling is legal
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    parent = state.latest_execution_payload_header
    payload = build_empty_execution_payload(spec, state)
    payload.gas_limit = (
        parent.gas_limit + parent.gas_limit // spec.GAS_LIMIT_DENOMINATOR - 1
    )
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_success_gas_limit_lower_edge(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    parent = state.latest_execution_payload_header
    payload = build_empty_execution_payload(spec, state)
    payload.gas_limit = (
        parent.gas_limit - parent.gas_limit // spec.GAS_LIMIT_DENOMINATOR + 1
    )
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_invalid_gas_limit_drop_too_large(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    parent = state.latest_execution_payload_header
    payload = build_empty_execution_payload(spec, state)
    payload.gas_limit = (
        parent.gas_limit - parent.gas_limit // spec.GAS_LIMIT_DENOMINATOR
    )
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_gas_limit_below_minimum(spec, state):
    build_state_with_complete_transition(spec, state)
    # shrink the parent limit to the floor, then dip under it
    state.latest_execution_payload_header.gas_limit = spec.MIN_GAS_LIMIT
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.gas_limit = spec.uint64(int(spec.MIN_GAS_LIMIT) - 1)
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_first_payload_bad_random(spec, state):
    # even the transition payload must carry the right randao mix
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.random = b'\x12' * 32
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_first_payload_bad_timestamp(spec, state):
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.timestamp = payload.timestamp + 1
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_invalid_future_block_number(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.block_number = payload.block_number + 10
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_header_reflects_transactions_root(spec, state):
    build_state_with_complete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.transactions = [spec.Transaction(b'\x77' * 8)]
    payload.block_hash = spec.Hash32(
        spec.hash(payload.hash_tree_root() + b"FAKE RLP HASH")
    )
    yield from run_execution_payload_processing(spec, state, payload)
    assert state.latest_execution_payload_header.transactions_root == (
        spec.hash_tree_root(payload.transactions)
    )


# -- further cases ----------------------------------------------------------


@with_phases([MERGE])
@spec_state_test
def test_first_payload_with_gap_slot(spec, state):
    # the merge-transition block may land after skipped slots: the payload
    # timestamp must track the BLOCK's slot, not the parent's
    from ...helpers.state import next_slots

    next_slots(spec, state, 3)
    payload = build_empty_execution_payload(spec, state)
    yield from run_execution_payload_processing(spec, state, payload)


@with_phases([MERGE])
@spec_state_test
def test_bad_timestamp_first_payload(spec, state):
    payload = build_empty_execution_payload(spec, state)
    payload.timestamp = payload.timestamp + 1
    yield from run_execution_payload_processing(spec, state, payload, valid=False)


@with_phases([MERGE])
@spec_state_test
def test_non_empty_extra_data_regular_payload(spec, state):
    from ...helpers.execution_payload import build_state_with_complete_transition

    build_state_with_complete_transition(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.extra_data = b"\x42" * 12
    yield from run_execution_payload_processing(spec, state, payload)
