"""Terminal-PoW / TTD fork-choice unit tests
(spec: reference specs/merge/fork-choice.md:93-131, validator.md:51-76)."""
from ...context import MERGE, expect_assertion_error, spec_state_test, with_phases
from ...helpers.execution_payload import (
    build_empty_execution_payload, build_state_with_incomplete_transition,
)
from ...helpers.state import next_slot


def _pow_block(spec, block_hash, parent_hash, td):
    return spec.PowBlock(
        block_hash=block_hash,
        parent_hash=parent_hash,
        total_difficulty=spec.uint256(td),
        difficulty=spec.uint256(0),
    )


def _with_ttd(spec, ttd):
    new_config = spec.config.copy()
    new_config.TERMINAL_TOTAL_DIFFICULTY = spec.uint256(ttd)
    return new_config


@with_phases([MERGE])
@spec_state_test
def test_is_valid_terminal_pow_block_ttd_crossing(spec, state):
    old_config = spec.config
    spec.config = _with_ttd(spec, 1000)
    try:
        parent = _pow_block(spec, b'\x01' * 32, b'\x00' * 32, 999)
        block = _pow_block(spec, b'\x02' * 32, b'\x01' * 32, 1000)
        assert spec.is_valid_terminal_pow_block(block, parent)
    finally:
        spec.config = old_config


@with_phases([MERGE])
@spec_state_test
def test_is_valid_terminal_pow_block_not_reached(spec, state):
    old_config = spec.config
    spec.config = _with_ttd(spec, 1000)
    try:
        parent = _pow_block(spec, b'\x01' * 32, b'\x00' * 32, 500)
        block = _pow_block(spec, b'\x02' * 32, b'\x01' * 32, 999)
        assert not spec.is_valid_terminal_pow_block(block, parent)
    finally:
        spec.config = old_config


@with_phases([MERGE])
@spec_state_test
def test_is_valid_terminal_pow_block_parent_already_terminal(spec, state):
    # the parent crossed TTD already: this block is past the terminal one
    old_config = spec.config
    spec.config = _with_ttd(spec, 1000)
    try:
        parent = _pow_block(spec, b'\x01' * 32, b'\x00' * 32, 1000)
        block = _pow_block(spec, b'\x02' * 32, b'\x01' * 32, 2000)
        assert not spec.is_valid_terminal_pow_block(block, parent)
    finally:
        spec.config = old_config


@with_phases([MERGE])
@spec_state_test
def test_get_terminal_pow_block_by_ttd(spec, state):
    old_config = spec.config
    spec.config = _with_ttd(spec, 1000)
    try:
        genesis = _pow_block(spec, b'\x00' * 32, b'\x00' * 32, 0)
        mid = _pow_block(spec, b'\x01' * 32, b'\x00' * 32, 900)
        terminal = _pow_block(spec, b'\x02' * 32, b'\x01' * 32, 1100)
        chain = {b.block_hash: b for b in (genesis, mid, terminal)}
        got = spec.get_terminal_pow_block(chain)
        assert got is not None and got.block_hash == terminal.block_hash
        # without a TTD crossing there is no terminal block
        chain_pre = {b.block_hash: b for b in (genesis, mid)}
        assert spec.get_terminal_pow_block(chain_pre) is None
    finally:
        spec.config = old_config


@with_phases([MERGE])
@spec_state_test
def test_validate_merge_block_rejects_non_terminal_parent(spec, state):
    # the built-in get_pow_block stub returns zero-difficulty blocks; with
    # mainnet-scale TTD the transition block must be rejected
    build_state_with_incomplete_transition(spec, state)
    next_slot(spec, state)
    payload = build_empty_execution_payload(spec, state)
    payload.parent_hash = b'\x0a' * 32
    block = spec.BeaconBlock(slot=state.slot)
    block.body.execution_payload = payload
    expect_assertion_error(lambda: spec.validate_merge_block(block))


@with_phases([MERGE])
@spec_state_test
def test_prepare_execution_payload_pre_and_post_merge(spec, state):
    old_config = spec.config
    spec.config = _with_ttd(spec, 1000)
    try:
        engine = spec.NoopExecutionEngine()
        fee_recipient = spec.ExecutionAddress()
        genesis = _pow_block(spec, b'\x00' * 32, b'\x00' * 32, 0)
        mid = _pow_block(spec, b'\x01' * 32, b'\x00' * 32, 900)
        chain = {b.block_hash: b for b in (genesis, mid)}

        # pre-merge, no terminal block yet: no payload to prepare
        build_state_with_incomplete_transition(spec, state)
        assert spec.prepare_execution_payload(
            state, chain, spec.Hash32(), fee_recipient, engine
        ) is None

        # terminal block appears: payload prepared on top of it
        terminal = _pow_block(spec, b'\x02' * 32, b'\x01' * 32, 1100)
        chain[terminal.block_hash] = terminal
        payload_id = spec.prepare_execution_payload(
            state, chain, spec.Hash32(), fee_recipient, engine
        )
        assert payload_id is not None

        # post-merge: prepared on the latest payload header
        from ...helpers.execution_payload import build_state_with_complete_transition

        build_state_with_complete_transition(spec, state)
        payload_id2 = spec.prepare_execution_payload(
            state, {}, spec.Hash32(), fee_recipient, engine
        )
        assert payload_id2 is not None and payload_id2 != payload_id
    finally:
        spec.config = old_config
