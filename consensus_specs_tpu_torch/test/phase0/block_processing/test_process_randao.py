"""process_randao tests
(spec: reference specs/phase0/beacon-chain.md:1719-1729)."""
from ...context import (
    always_bls, expect_assertion_error, spec_state_test, with_all_phases,
)
from ...helpers.block import build_empty_block_for_next_slot
from ...helpers.keys import privkeys
from ...helpers.state import next_slot


def run_randao_processing(spec, state, body, valid=True):
    yield 'pre', state
    yield 'body', body
    if not valid:
        expect_assertion_error(lambda: spec.process_randao(state, body))
        yield 'post', None
        return
    spec.process_randao(state, body)
    yield 'post', state


@with_all_phases
@spec_state_test
@always_bls
def test_success_mixes_reveal(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    next_slot(spec, state)
    epoch = spec.get_current_epoch(state)
    pre_mix = spec.get_randao_mix(state, epoch)
    yield from run_randao_processing(spec, state, block.body)
    post_mix = spec.get_randao_mix(state, epoch)
    assert post_mix != pre_mix
    # the mix is the xor of the previous mix with the reveal's hash
    assert post_mix == spec.xor(pre_mix, spec.hash(block.body.randao_reveal))


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_reveal_wrong_epoch(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    proposer_index = spec.get_beacon_proposer_index(state)
    # reveal signs the WRONG epoch number
    wrong_epoch = spec.get_current_epoch(state) + 1
    domain = spec.get_domain(state, spec.DOMAIN_RANDAO, wrong_epoch)
    signing_root = spec.compute_signing_root(spec.Epoch(wrong_epoch), domain)
    block.body.randao_reveal = spec.bls.Sign(privkeys[proposer_index], signing_root)
    next_slot(spec, state)
    yield from run_randao_processing(spec, state, block.body, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_reveal_wrong_proposer(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    proposer_index = spec.get_beacon_proposer_index(state)
    other = (proposer_index + 1) % len(state.validators)
    epoch = spec.compute_epoch_at_slot(block.slot)
    domain = spec.get_domain(state, spec.DOMAIN_RANDAO, epoch)
    signing_root = spec.compute_signing_root(spec.Epoch(epoch), domain)
    block.body.randao_reveal = spec.bls.Sign(privkeys[other], signing_root)
    next_slot(spec, state)
    yield from run_randao_processing(spec, state, block.body, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_zeroed_reveal(spec, state):
    block = build_empty_block_for_next_slot(spec, state)
    block.body.randao_reveal = spec.BLSSignature()
    next_slot(spec, state)
    yield from run_randao_processing(spec, state, block.body, valid=False)
