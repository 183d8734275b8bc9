"""Attestation fixtures: data/vote construction, committee signing, and
epoch-filling transition drivers.

Role parity with the reference's
attestation helper module: craft valid AttestationData for any in-range
slot (reference specs/phase0/validator.md:278-333 for the vote recipe),
sign per committee with the deterministic keys, and drive whole epochs of
block-borne attestations for finality scenarios.
"""
from .block import build_empty_block_for_next_slot
from .forks import is_post_altair
from .keys import privkeys
from .state import state_transition_and_sign_block, transition_to


# -- vote construction -------------------------------------------------------


def _head_root_for(spec, state, slot, override):
    """The head-vote root an attester at ``slot`` would use."""
    if override is not None:
        return override
    if slot == state.slot:
        # the chain head as the next proposer would see it
        return build_empty_block_for_next_slot(spec, state).parent_root
    return spec.get_block_root_at_slot(state, slot)


def _target_and_source(spec, state, slot, head_root):
    """(target checkpoint root, source checkpoint) per the honest-validator
    vote rules: the target is the attested epoch's boundary block, the
    source is the justified checkpoint the state held for that epoch."""
    epoch = spec.compute_epoch_at_slot(slot)
    boundary = spec.compute_start_slot_at_epoch(spec.get_current_epoch(state))
    if slot < boundary:
        target_root = spec.get_block_root(state, spec.get_previous_epoch(state))
        source = state.previous_justified_checkpoint
    else:
        target_root = head_root if slot == boundary else spec.get_block_root(
            state, spec.get_current_epoch(state)
        )
        source = state.current_justified_checkpoint
    return spec.Checkpoint(epoch=epoch, root=target_root), source


def build_attestation_data(spec, state, slot, index, beacon_block_root=None):
    assert state.slot >= slot
    head = _head_root_for(spec, state, slot, beacon_block_root)
    target, source = _target_and_source(spec, state, slot, head)
    return spec.AttestationData(
        slot=slot,
        index=index,
        beacon_block_root=head,
        source=spec.Checkpoint(epoch=source.epoch, root=source.root),
        target=target,
    )


# -- signing -----------------------------------------------------------------


def get_attestation_signature(spec, state, attestation_data, privkey):
    root = spec.compute_signing_root(
        attestation_data,
        spec.get_domain(state, spec.DOMAIN_BEACON_ATTESTER, attestation_data.target.epoch),
    )
    return spec.bls.Sign(privkey, root)


def sign_aggregate_attestation(spec, state, attestation_data, participants):
    return spec.bls.Aggregate([
        get_attestation_signature(spec, state, attestation_data, privkeys[i])
        for i in participants
    ])


def sign_indexed_attestation(spec, state, indexed_attestation):
    indexed_attestation.signature = sign_aggregate_attestation(
        spec, state, indexed_attestation.data,
        indexed_attestation.attesting_indices,
    )


def sign_attestation(spec, state, attestation):
    voters = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    )
    attestation.signature = sign_aggregate_attestation(
        spec, state, attestation.data, voters
    )


# -- whole attestations ------------------------------------------------------


def fill_aggregate_attestation(spec, state, attestation, signed=False,
                               filter_participant_set=None):
    """Set participation bits for the (optionally filtered) committee and
    optionally sign. An empty filtered set leaves a zero signature — such
    an attestation is only meaningful if participants are added later."""
    committee = spec.get_beacon_committee(
        state, attestation.data.slot, attestation.data.index
    )
    chosen = set(committee)
    if filter_participant_set is not None:
        chosen = filter_participant_set(chosen)
    for pos, member in enumerate(committee):
        attestation.aggregation_bits[pos] = member in chosen
    if signed and chosen:
        sign_attestation(spec, state, attestation)


def get_valid_attestation(spec, state, slot=None, index=None,
                          filter_participant_set=None, beacon_block_root=None,
                          signed=False):
    """A valid attestation for (``slot``, committee ``index``), full
    committee participation unless filtered."""
    slot = state.slot if slot is None else slot
    index = 0 if index is None else index
    data = build_attestation_data(
        spec, state, slot=slot, index=index, beacon_block_root=beacon_block_root
    )
    width = len(spec.get_beacon_committee(state, data.slot, data.index))
    att = spec.Attestation(
        data=data,
        aggregation_bits=spec.Bitlist[spec.MAX_VALIDATORS_PER_COMMITTEE](
            [0] * width
        ),
    )
    fill_aggregate_attestation(
        spec, state, att, signed=signed, filter_participant_set=filter_participant_set
    )
    return att


# -- handler driver ----------------------------------------------------------


def run_attestation_processing(spec, state, attestation, valid=True):
    """Drive ``process_attestation`` as a test vector: yields
    (pre, attestation, post); invalid ops must assert (``post: None``)."""
    from ..context import expect_assertion_error

    yield "pre", state
    yield "attestation", attestation

    if not valid:
        expect_assertion_error(lambda: spec.process_attestation(state, attestation))
        yield "post", None
        return

    to_current = attestation.data.target.epoch == spec.get_current_epoch(state)
    if is_post_altair(spec):
        # effect check: the flags this attestation should earn must be set
        # for every voter afterwards (participation replaced the pending
        # queues, reference specs/altair/beacon-chain.md:452-490)
        due_flags = spec.get_attestation_participation_flag_indices(
            state, attestation.data, state.slot - attestation.data.slot
        )
        voters = list(spec.get_attesting_indices(
            state, attestation.data, attestation.aggregation_bits
        ))
    else:
        pending_before = len(
            state.current_epoch_attestations if to_current
            else state.previous_epoch_attestations
        )

    spec.process_attestation(state, attestation)

    if is_post_altair(spec):
        ledger = (
            state.current_epoch_participation if to_current
            else state.previous_epoch_participation
        )
        assert all(
            spec.has_flag(ledger[v], f) for v in voters for f in due_flags
        )
    else:
        queue = (
            state.current_epoch_attestations if to_current
            else state.previous_epoch_attestations
        )
        assert len(queue) == pending_before + 1

    yield "post", state


# -- epoch drivers -----------------------------------------------------------


def add_attestations_to_state(spec, state, attestations, slot):
    transition_to(spec, state, slot)
    for attestation in attestations:
        spec.process_attestation(state, attestation)


def _committee_votes_for(spec, state, slot, participation_fn=None):
    """One signed full(-or-filtered) attestation per committee of ``slot``."""
    epoch = spec.compute_epoch_at_slot(slot)
    for index in range(spec.get_committee_count_per_slot(state, epoch)):
        flt = None
        if participation_fn is not None:
            def flt(comm, _idx=index):
                return participation_fn(state.slot, _idx, comm)
        yield get_valid_attestation(
            spec, state, slot, index=index, signed=True,
            filter_participant_set=flt,
        )


def state_transition_with_full_block(spec, state, fill_cur_epoch,
                                     fill_prev_epoch, participation_fn=None):
    """Apply one block carrying every committee's attestation for the
    freshest includable slot of the current and/or previous epoch."""
    block = build_empty_block_for_next_slot(spec, state)
    targets = []
    if fill_cur_epoch and state.slot >= spec.MIN_ATTESTATION_INCLUSION_DELAY:
        fresh = state.slot - spec.MIN_ATTESTATION_INCLUSION_DELAY + 1
        if fresh >= spec.compute_start_slot_at_epoch(spec.get_current_epoch(state)):
            targets.append(fresh)
    if fill_prev_epoch:
        targets.append(state.slot - spec.SLOTS_PER_EPOCH + 1)
    for slot in targets:
        for att in _committee_votes_for(spec, state, slot, participation_fn):
            block.body.attestations.append(att)
    return state_transition_and_sign_block(spec, state, block)


def next_slots_with_attestations(spec, state, slot_count, fill_cur_epoch,
                                 fill_prev_epoch, participation_fn=None):
    """(pre_state, signed blocks, post_state) after ``slot_count`` blocks
    of attestation filling; the input state is left untouched."""
    post = state.copy()
    signed = [
        state_transition_with_full_block(
            spec, post, fill_cur_epoch, fill_prev_epoch, participation_fn
        )
        for _ in range(slot_count)
    ]
    return state, signed, post


def next_epoch_with_attestations(spec, state, fill_cur_epoch, fill_prev_epoch,
                                 participation_fn=None):
    assert state.slot % spec.SLOTS_PER_EPOCH == 0
    return next_slots_with_attestations(
        spec, state, spec.SLOTS_PER_EPOCH, fill_cur_epoch, fill_prev_epoch,
        participation_fn,
    )
