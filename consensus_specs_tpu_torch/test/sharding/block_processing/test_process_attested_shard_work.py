"""Shard-work vote accounting through the extended attestation processing
(original; reference specs/sharding/beacon-chain.md:584-672)."""
from ...context import CUSTODY_GAME, SHARDING, spec_state_test, with_phases
from ...helpers.attestations import get_valid_attestation, sign_attestation
from ...helpers.shard_blob import build_shard_blob_header
from ...helpers.state import next_epoch, next_slot


def _attest(spec, state, slot, index, shard_blob_root, participant_filter=None):
    """Committee attestation voting shard_blob_root, signed after the vote
    is set so real-BLS (generator) runs verify."""
    attestation = get_valid_attestation(
        spec, state, slot=slot, index=index, filter_participant_set=participant_filter,
    )
    attestation.data.shard_blob_root = shard_blob_root
    sign_attestation(spec, state, attestation)
    return attestation


def _armed_state(spec, state):
    next_epoch(spec, state)
    next_slot(spec, state)


def _work(spec, state, slot, shard):
    return state.shard_buffer[int(slot) % int(spec.SHARD_STATE_MEMORY_SLOTS)][int(shard)]


def _include_header(spec, state, slot, shard=0):
    signed = build_shard_blob_header(spec, state, slot=slot, shard=shard)
    spec.process_shard_header(state, signed)
    return spec.hash_tree_root(signed.message)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_full_committee_confirms_header(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    header_root = _include_header(spec, state, slot, shard=0)

    attestation = _attest(spec, state, slot, 0, header_root)

    yield 'pre', state
    yield 'attestation', attestation
    spec.process_attestation(state, attestation)
    yield 'post', state

    work = _work(spec, state, slot, 0)
    assert work.status.selector == spec.SHARD_WORK_CONFIRMED
    assert work.status.value.root == header_root
    # the winning committee is remembered with the shard participation flag
    committee = spec.get_beacon_committee(state, slot, spec.CommitteeIndex(0))
    for index in committee:
        assert spec.has_flag(
            state.current_epoch_participation[index], spec.TIMELY_SHARD_FLAG_INDEX
        )


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_minority_vote_stays_pending(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    header_root = _include_header(spec, state, slot, shard=0)

    # under 2/3 of the committee: take ~1/4 of it
    attestation = _attest(
        spec, state, slot, 0, header_root,
        participant_filter=lambda s: set(list(sorted(s))[: max(1, len(s) // 4)]),
    )

    spec.process_attestation(state, attestation)

    work = _work(spec, state, slot, 0)
    assert work.status.selector == spec.SHARD_WORK_PENDING
    headers = work.status.value
    match = [h for h in headers if h.attested.root == header_root]
    assert len(match) == 1
    assert match[0].weight > 0
    assert match[0].update_slot == state.slot


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_empty_commitment_vote_unconfirms(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    # vote for the default empty pending header (zeroed root): a 2/3 vote to
    # confirm "nothing" nullifies the bucket
    attestation = _attest(spec, state, slot, 0, spec.Root())

    spec.process_attestation(state, attestation)

    work = _work(spec, state, slot, 0)
    assert work.status.selector == spec.SHARD_WORK_UNCONFIRMED


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_unknown_header_vote_is_ignored(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    attestation = _attest(spec, state, slot, 0, spec.Root(b'\x55' * 32))

    pre_headers = len(_work(spec, state, slot, 0).status.value)
    spec.process_attestation(state, attestation)

    work = _work(spec, state, slot, 0)
    # still pending, nothing counted
    assert work.status.selector == spec.SHARD_WORK_PENDING
    assert len(work.status.value) == pre_headers
    assert all(h.weight == 0 for h in work.status.value)


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_confirmed_match_applies_flags_to_late_attesters(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    header_root = _include_header(spec, state, slot, shard=0)

    confirm = _attest(spec, state, slot, 0, header_root)
    spec.process_attestation(state, confirm)
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_CONFIRMED

    # a later matching attestation still earns the shard flag
    late = _attest(spec, state, slot, 0, header_root)
    spec.process_attestation(state, late)

    committee = spec.get_beacon_committee(state, slot, spec.CommitteeIndex(0))
    for index in committee:
        assert spec.has_flag(
            state.current_epoch_participation[index], spec.TIMELY_SHARD_FLAG_INDEX
        )


@with_phases([SHARDING, CUSTODY_GAME])
@spec_state_test
def test_votes_accumulate_across_attestations(spec, state):
    _armed_state(spec, state)
    slot = state.slot - 1
    header_root = _include_header(spec, state, slot, shard=0)

    committee = list(spec.get_beacon_committee(state, slot, spec.CommitteeIndex(0)))
    half_1 = set(committee[: len(committee) // 3])
    half_2 = set(committee[len(committee) // 3: 2 * len(committee) // 3 + 1])

    a1 = _attest(spec, state, slot, 0, header_root,
                 participant_filter=lambda s: half_1)
    spec.process_attestation(state, a1)
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_PENDING

    a2 = _attest(spec, state, slot, 0, header_root,
                 participant_filter=lambda s: half_1 | half_2)
    spec.process_attestation(state, a2)
    # cumulative distinct votes now cover > 2/3 of the committee balance
    assert _work(spec, state, slot, 0).status.selector == spec.SHARD_WORK_CONFIRMED
