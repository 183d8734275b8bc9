"""process_proposer_slashing handler suite.

Walks the handler's guard chain — header equivocation (same slot, same
proposer, different content), both signatures, slashability of the
target — and, via run_proposer_slashing_processing's effect audit, the
full balance/flag consequences of a landed slashing. Scenario coverage
mirrors the reference handler suite (tests/core/pyspec/eth2spec/test/
phase0/block_processing/test_process_proposer_slashing.py); bodies and
the extra divergence/slot scenarios are this repo's own.
"""
from ...context import always_bls, spec_state_test, with_all_phases
from ...helpers.block import build_empty_block_for_next_slot, sign_block_header
from ...helpers.keys import privkeys
from ...helpers.proposer_slashings import (
    get_valid_proposer_slashing, run_proposer_slashing_processing,
    slashable_header_pair,
)
from ...helpers.state import next_epoch


def _resign_header_2(spec, state, slashing):
    """Re-sign envelope 2 after a caller mutated its message — signature
    checks must fail on the EQUIVOCATION guards, not on a stale sig."""
    msg = slashing.signed_header_2.message
    slashing.signed_header_2 = sign_block_header(
        spec, state, msg, privkeys[msg.proposer_index]
    )


@with_all_phases
@spec_state_test
def test_success(spec, state):
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    yield from run_proposer_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
def test_success_slashed_and_proposer_index_the_same(spec, state):
    # the equivocator is also the block's own proposer: the whistleblower
    # reward and the penalty land on the SAME balance (the effect audit
    # checks the net) — the self-report corner of slash_validator
    duty_holder = build_empty_block_for_next_slot(spec, state).proposer_index
    slashing = get_valid_proposer_slashing(
        spec, state, slashed_index=duty_holder, signed_1=True, signed_2=True
    )
    yield from run_proposer_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
def test_success_block_header_from_future(spec, state):
    # equivocation dated AHEAD of the clock still slashes: the handler
    # compares the two headers to each other, never to state.slot
    slashing = get_valid_proposer_slashing(
        spec, state, slot=state.slot + 5, signed_1=True, signed_2=True
    )
    yield from run_proposer_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
def test_success_divergence_in_body_root_only(spec, state):
    # ANY field difference is slashable — build the pair by hand with the
    # divergence in body_root instead of the fixture's parent_root
    epoch = spec.get_current_epoch(state)
    target = spec.get_active_validator_indices(state, epoch)[-1]
    h1, h2 = slashable_header_pair(spec, state, target, state.slot)
    h2.parent_root = h1.parent_root  # undo the fixture divergence...
    h2.body_root = b"\x77" * 32  # ...and diverge elsewhere
    sk = privkeys[target]
    slashing = spec.ProposerSlashing(
        signed_header_1=sign_block_header(spec, state, h1, sk),
        signed_header_2=sign_block_header(spec, state, h2, sk),
    )
    yield from run_proposer_slashing_processing(spec, state, slashing)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_1(spec, state):
    slashing = get_valid_proposer_slashing(spec, state, signed_1=False, signed_2=True)
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_2(spec, state):
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=False)
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_1_and_2(spec, state):
    slashing = get_valid_proposer_slashing(spec, state, signed_1=False, signed_2=False)
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_invalid_sig_1_and_2_swap(spec, state):
    # each signature is valid for the OTHER header: both verifications
    # must be header-bound, so a swap fails
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    s1, s2 = slashing.signed_header_1, slashing.signed_header_2
    s1.signature, s2.signature = s2.signature.copy(), s1.signature.copy()
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_proposer_index(spec, state):
    # an index one past the registry: the handler must refuse before any
    # registry access
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    ghost = len(state.validators)
    slashing.signed_header_1.message.proposer_index = ghost
    slashing.signed_header_2.message.proposer_index = ghost
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_different_proposer_indices(spec, state):
    # two validators each signing their own header is not equivocation
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    accused = slashing.signed_header_1.message.proposer_index
    epoch = spec.get_current_epoch(state)
    other = next(
        i for i in spec.get_active_validator_indices(state, epoch) if i != accused
    )
    slashing.signed_header_2.message.proposer_index = other
    _resign_header_2(spec, state, slashing)
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_epochs_are_different(spec, state):
    # same proposer, different epochs: not a double proposal
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=False)
    slashing.signed_header_2.message.slot += spec.SLOTS_PER_EPOCH
    _resign_header_2(spec, state, slashing)
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_invalid_slots_differ_same_epoch(spec, state):
    # one slot apart WITHIN an epoch — still not the same-slot condition
    # (the guard is header_1.slot == header_2.slot, not epoch equality)
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=False)
    slashing.signed_header_2.message.slot += 1
    _resign_header_2(spec, state, slashing)
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_headers_are_same_sigs_are_same(spec, state):
    # a verbatim duplicate is one proposal, not two
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=False)
    slashing.signed_header_2 = slashing.signed_header_1.copy()
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
@always_bls
def test_headers_are_same_sigs_are_different(spec, state):
    # identical messages under different signature bytes: still the same
    # header, so still no equivocation (the header guard fires before
    # signature verification can)
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    slashing.signed_header_2 = slashing.signed_header_1.copy()
    slashing.signed_header_2.signature = spec.BLSSignature(
        bytes(slashing.signed_header_1.signature)[:-1] + b"\x01"
    )
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_proposer_is_not_activated(spec, state):
    # not yet active => not slashable (is_slashable_validator window)
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    accused = slashing.signed_header_1.message.proposer_index
    state.validators[accused].activation_epoch = spec.get_current_epoch(state) + 1
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_proposer_is_slashed(spec, state):
    # double jeopardy: an already-slashed validator can't be slashed again
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    accused = slashing.signed_header_1.message.proposer_index
    state.validators[accused].slashed = True
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)


@with_all_phases
@spec_state_test
def test_proposer_is_withdrawn(spec, state):
    # past the withdrawable epoch the stake is gone — nothing to slash
    slashing = get_valid_proposer_slashing(spec, state, signed_1=True, signed_2=True)
    next_epoch(spec, state)
    accused = slashing.signed_header_1.message.proposer_index
    state.validators[accused].withdrawable_epoch = spec.get_current_epoch(state) - 1
    yield from run_proposer_slashing_processing(spec, state, slashing, valid=False)
