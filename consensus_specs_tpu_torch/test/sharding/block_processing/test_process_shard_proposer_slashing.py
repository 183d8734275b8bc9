"""process_shard_proposer_slashing tests (original; reference
specs/sharding/beacon-chain.md:771-806)."""
from ...context import CUSTODY_GAME, SHARDING, always_bls, expect_assertion_error, spec_state_test, with_phases
from ...helpers.shard_blob import build_shard_proposer_slashing
from ...helpers.state import next_epoch, next_slot


def run_shard_proposer_slashing_processing(spec, state, slashing, valid=True):
    yield 'pre', state
    yield 'shard_proposer_slashing', slashing

    if not valid:
        expect_assertion_error(
            lambda: spec.process_shard_proposer_slashing(state, slashing)
        )
        yield 'post', None
        return

    spec.process_shard_proposer_slashing(state, slashing)
    yield 'post', state


def _prep(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_proposer_slashing_accepted(spec, state):
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    proposer = slashing.proposer_index
    assert not state.validators[proposer].slashed

    yield from run_shard_proposer_slashing_processing(spec, state, slashing)

    assert state.validators[proposer].slashed


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_proposer_slashing_accepted_real_signatures(spec, state):
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    yield from run_shard_proposer_slashing_processing(spec, state, slashing)
    assert state.validators[slashing.proposer_index].slashed


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_proposer_slashing_identical_references(spec, state):
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    slashing.builder_index_2 = slashing.builder_index_1
    slashing.body_root_2 = slashing.body_root_1
    slashing.signature_2 = slashing.signature_1
    yield from run_shard_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_proposer_slashing_already_slashed(spec, state):
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    state.validators[slashing.proposer_index].slashed = True
    yield from run_shard_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_proposer_slashing_withdrawn_proposer(spec, state):
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    # no longer slashable once withdrawable
    state.validators[slashing.proposer_index].withdrawable_epoch = spec.get_current_epoch(state)
    state.validators[slashing.proposer_index].exit_epoch = spec.get_current_epoch(state)
    yield from run_shard_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_proposer_slashing_bad_signature_1(spec, state):
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    slashing.signature_1 = spec.BLSSignature(b'\x13' * 96)
    yield from run_shard_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_proposer_slashing_swapped_builders(spec, state):
    # valid signatures but attributed to the wrong builder indices
    _prep(spec, state)
    slashing = build_shard_proposer_slashing(spec, state, slot=state.slot - 1)
    slashing.builder_index_1, slashing.builder_index_2 = (
        slashing.builder_index_2, slashing.builder_index_1
    )
    yield from run_shard_proposer_slashing_processing(spec, state, slashing, valid=False)
