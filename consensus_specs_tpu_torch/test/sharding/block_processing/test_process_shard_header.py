"""process_shard_header tests (original; reference
specs/sharding/beacon-chain.md:674-769 — the reference ships no tests for
this handler since the draft fork is not executable there).

State setup: one epoch transition past genesis so reset_pending_shard_work
has armed the current epoch's (slot, shard) slots with SHARD_WORK_PENDING
lists (beacon-chain.md:846-888).
"""
from ...context import CUSTODY_GAME, SHARDING, always_bls, expect_assertion_error, spec_state_test, with_phases
from ...helpers.shard_blob import (
    build_data_commitment,
    build_shard_blob_header,
    get_sample_blob_data,
    sign_shard_blob_header,
)
from ...helpers.state import next_epoch, next_slot


def run_shard_header_processing(spec, state, signed_header, valid=True):
    yield 'pre', state
    yield 'shard_blob_header', signed_header

    if not valid:
        expect_assertion_error(lambda: spec.process_shard_header(state, signed_header))
        yield 'post', None
        return

    spec.process_shard_header(state, signed_header)
    yield 'post', state


def _armed_state(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)  # a strictly-past slot with pending work exists
    return state


def _pending_headers(spec, state, slot, shard):
    work = state.shard_buffer[int(slot) % int(spec.SHARD_STATE_MEMORY_SLOTS)][int(shard)]
    assert work.status.selector == spec.SHARD_WORK_PENDING
    return work.status.value


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_accepted(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    signed = build_shard_blob_header(spec, state, slot=slot, shard=0)
    pre_count = len(_pending_headers(spec, state, slot, 0))
    pre_builder_balance = state.blob_builder_balances[0]

    yield from run_shard_header_processing(spec, state, signed)

    headers = _pending_headers(spec, state, slot, 0)
    assert len(headers) == pre_count + 1
    assert headers[-1].attested.root == spec.hash_tree_root(signed.message)
    assert headers[-1].weight == 0
    assert headers[-1].update_slot == state.slot
    # base fee burned from the builder
    samples = signed.message.body_summary.commitment.samples_count
    assert state.blob_builder_balances[0] == (
        pre_builder_balance - state.shard_sample_price * samples
    )


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_priority_fee_paid_to_proposer(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    tip = spec.Gwei(5)
    signed = build_shard_blob_header(
        spec, state, slot=slot, shard=0,
        max_fee_per_sample=state.shard_sample_price + tip,
        max_priority_fee_per_sample=tip,
    )
    proposer = signed.message.proposer_index
    pre_proposer_balance = state.balances[proposer]
    pre_builder_balance = state.blob_builder_balances[0]

    yield from run_shard_header_processing(spec, state, signed)

    samples = signed.message.body_summary.commitment.samples_count
    assert state.balances[proposer] == pre_proposer_balance + tip * samples
    assert state.blob_builder_balances[0] == (
        pre_builder_balance - (state.shard_sample_price + tip) * samples
    )


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_header_accepted_real_crypto(spec, state):
    # end-to-end with the real builder+proposer aggregate signature and the
    # real KZG degree-proof pairing equation
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0)
    yield from run_shard_header_processing(spec, state, signed)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_header_invalid_degree_proof(spec, state):
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0, signed=False)
    # degree proof for DIFFERENT data: pairing equation must fail
    other = get_sample_blob_data(spec, samples_count=1, seed=99)
    _, wrong_proof = build_data_commitment(spec, other)
    signed.message.body_summary.degree_proof = wrong_proof
    signed = sign_shard_blob_header(spec, state, signed.message)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_header_bad_signature(spec, state):
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0)
    signed.signature = spec.BLSSignature(b'\x42' * 96)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_zero_slot(spec, state):
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0, signed=False)
    signed.message.slot = spec.Slot(0)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_future_slot(spec, state):
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot, shard=0, signed=False)
    signed.message.slot = state.slot + 1
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_stale_epoch(spec, state):
    # two epochs past the header's slot: epoch is neither previous nor current
    next_epoch(spec, state)
    stale_slot = state.slot  # epoch 1
    next_epoch(spec, state)
    next_epoch(spec, state)  # now epoch 3
    signed = build_shard_blob_header(spec, state, slot=stale_slot, shard=0, signed=False)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_invalid_shard(spec, state):
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0, signed=False)
    signed.message.shard = spec.get_active_shard_count(state, spec.get_current_epoch(state))
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_not_pending(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    shard = 0
    # flip the work bucket to UNCONFIRMED: no pending list to join
    state.shard_buffer[int(slot) % int(spec.SHARD_STATE_MEMORY_SLOTS)][shard].status.change(
        selector=spec.SHARD_WORK_UNCONFIRMED, value=None,
    )
    signed = build_shard_blob_header(spec, state, slot=slot, shard=shard, signed=False)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_duplicate(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    signed = build_shard_blob_header(spec, state, slot=slot, shard=0)
    spec.process_shard_header(state, signed)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_wrong_proposer(spec, state):
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0, signed=False)
    signed.message.proposer_index = (signed.message.proposer_index + 1) % len(state.validators)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_insufficient_builder_balance(spec, state):
    _armed_state(spec, state)
    state.blob_builder_balances[0] = spec.Gwei(0)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_max_fee_below_base_fee(spec, state):
    _armed_state(spec, state)
    # price floor is MIN_SAMPLE_PRICE > 0: a zero max fee cannot cover it
    signed = build_shard_blob_header(
        spec, state, slot=state.slot - 1, shard=0, max_fee_per_sample=spec.Gwei(0),
    )
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
@always_bls
def test_shard_header_oversized_samples_count(spec, state):
    # samples_count beyond the blob ceiling indexes past the trusted setup:
    # the degree check must reject, never wrap to a wrong setup point
    _armed_state(spec, state)
    signed = build_shard_blob_header(spec, state, slot=state.slot - 1, shard=0, signed=False)
    signed.message.body_summary.commitment.samples_count = spec.MAX_SAMPLES_PER_BLOB * 2
    signed.message.body_summary.degree_proof = signed.message.body_summary.commitment.point
    signed = sign_shard_blob_header(spec, state, signed.message)
    yield from run_shard_header_processing(spec, state, signed, valid=False)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_shard_header_pending_list_full(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    for seed in range(int(spec.MAX_SHARD_HEADERS_PER_SHARD) - 1):  # one dummy pre-exists
        signed = build_shard_blob_header(spec, state, slot=slot, shard=0,
                                         data_seed=1000 + seed)
        spec.process_shard_header(state, signed)
    # list is now at MAX_SHARD_HEADERS_PER_SHARD: the next append must fail
    signed = build_shard_blob_header(spec, state, slot=slot, shard=0, data_seed=4242)
    yield from run_shard_header_processing(spec, state, signed, valid=False)
