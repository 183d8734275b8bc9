"""Altair validator-duty unit tests: sync-committee assignments, subnets,
aggregation (spec: reference specs/altair/validator.md:70-424,
specs/altair/p2p-interface.md:124-138)."""
from ...context import ALTAIR, always_bls, spec_state_test, with_phases
from ...helpers.keys import privkeys, pubkeys
from ...helpers.sync_committee import get_committee_indices


@with_phases([ALTAIR])
@spec_state_test
def test_sync_committee_assignment_consistency(spec, state):
    epoch = spec.get_current_epoch(state)
    committee_members = set(get_committee_indices(spec, state))
    for index in range(len(state.validators)):
        assigned = spec.is_assigned_to_sync_committee(state, epoch, index)
        assert assigned == (index in committee_members)


@with_phases([ALTAIR])
@spec_state_test
def test_compute_subnets_cover_all_seats(spec, state):
    size = int(spec.SYNC_COMMITTEE_SIZE)
    sub_size = size // int(spec.SYNC_COMMITTEE_SUBNET_COUNT)
    committee_indices = get_committee_indices(spec, state)
    for index in set(committee_indices):
        subnets = spec.compute_subnets_for_sync_committee(state, index)
        expected = {
            spec.uint64(seat // sub_size)
            for seat, v in enumerate(committee_indices) if v == index
        }
        assert set(int(s) for s in subnets) == set(int(s) for s in expected)


@with_phases([ALTAIR])
@spec_state_test
def test_get_sync_subcommittee_pubkeys_partition(spec, state):
    # the subcommittee views tile the full committee exactly
    all_pubkeys = []
    for sub in range(int(spec.SYNC_COMMITTEE_SUBNET_COUNT)):
        all_pubkeys.extend(spec.get_sync_subcommittee_pubkeys(state, spec.uint64(sub)))
    assert list(all_pubkeys) == list(state.current_sync_committee.pubkeys)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_sync_committee_message_verifies(spec, state):
    block_root = spec.Root(b"\x77" * 32)
    index = 0
    msg = spec.get_sync_committee_message(state, block_root, index, privkeys[index])
    assert msg.slot == state.slot
    assert msg.beacon_block_root == block_root
    domain = spec.get_domain(
        state, spec.DOMAIN_SYNC_COMMITTEE, spec.get_current_epoch(state)
    )
    signing_root = spec.compute_signing_root(block_root, domain)
    assert spec.bls.Verify(pubkeys[index], signing_root, msg.signature)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_contribution_and_proof_flow(spec, state):
    # contributions aggregate into the block's SyncAggregate shape
    sub_size = int(spec.SYNC_COMMITTEE_SIZE) // int(spec.SYNC_COMMITTEE_SUBNET_COUNT)
    contribution = spec.SyncCommitteeContribution(
        slot=state.slot,
        beacon_block_root=b"\x88" * 32,
        subcommittee_index=1,
        aggregation_bits=[True] * sub_size,
        signature=spec.bls.Sign(privkeys[0], b"\x88" * 32),
    )
    cap = spec.get_contribution_and_proof(state, 0, contribution, privkeys[0])
    assert cap.contribution == contribution
    sig = spec.get_contribution_and_proof_signature(state, cap, privkeys[0])
    domain = spec.get_domain(
        state, spec.DOMAIN_CONTRIBUTION_AND_PROOF,
        spec.compute_epoch_at_slot(contribution.slot),
    )
    assert spec.bls.Verify(
        pubkeys[0], spec.compute_signing_root(cap, domain), sig
    )

    block = spec.BeaconBlock(slot=state.slot)
    spec.process_sync_committee_contributions(block, {contribution})
    bits = block.body.sync_aggregate.sync_committee_bits
    assert sum(bits) == sub_size
    # the set seats are exactly subcommittee 1's range
    assert all(
        bits[i] == (sub_size <= i < 2 * sub_size) for i in range(len(bits))
    )


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_sync_committee_selection_deterministic(spec, state):
    proofs = [
        spec.get_sync_committee_selection_proof(state, state.slot, sub, privkeys[0])
        for sub in range(int(spec.SYNC_COMMITTEE_SUBNET_COUNT))
    ]
    # distinct subcommittees sign distinct selection data
    assert len(set(proofs)) == len(proofs)
    for p in proofs:
        a = spec.is_sync_committee_aggregator(p)
        assert a == spec.is_sync_committee_aggregator(p)


@with_phases([ALTAIR])
@spec_state_test
def test_process_sync_committee_contributions_assembles_aggregate(spec, state):
    # contributions from every subnet fold into one block-level aggregate
    from ...helpers.sync_committee import compute_sync_committee_signing_root

    block = spec.BeaconBlock(slot=state.slot + 1)
    committee = get_committee_indices(spec, state)
    signing_root = compute_sync_committee_signing_root(spec, state, block.slot)
    subnet_count = int(spec.SYNC_COMMITTEE_SUBNET_COUNT)
    per_subnet = int(spec.SYNC_COMMITTEE_SIZE) // subnet_count

    contributions = []
    for subnet in range(subnet_count):
        seats = range(subnet * per_subnet, (subnet + 1) * per_subnet)
        bits = [False] * per_subnet
        sigs = []
        for off, seat in enumerate(seats):
            bits[off] = True
            sigs.append(spec.bls.Sign(privkeys[committee[seat]], signing_root))
        contributions.append(spec.SyncCommitteeContribution(
            slot=block.slot,
            beacon_block_root=spec.Root(),
            subcommittee_index=subnet,
            aggregation_bits=bits,
            signature=spec.bls.Aggregate(sigs),
        ))

    spec.process_sync_committee_contributions(block, set(contributions))
    assert all(bool(b) for b in block.body.sync_aggregate.sync_committee_bits)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_sync_committee_selection_proof_verifies(spec, state):
    slot = state.slot
    subcommittee_index = spec.uint64(0)
    validator_index = 5
    proof = spec.get_sync_committee_selection_proof(
        state, slot, subcommittee_index, privkeys[validator_index]
    )
    domain = spec.get_domain(
        state, spec.DOMAIN_SYNC_COMMITTEE_SELECTION_PROOF,
        spec.compute_epoch_at_slot(slot),
    )
    signing_data = spec.SyncAggregatorSelectionData(
        slot=slot, subcommittee_index=subcommittee_index
    )
    signing_root = spec.compute_signing_root(signing_data, domain)
    assert spec.bls.Verify(pubkeys[validator_index], signing_root, proof)


@with_phases([ALTAIR])
@spec_state_test
def test_is_sync_committee_aggregator_threshold(spec, state):
    # the selection rule is a hash-mod threshold: deterministic for a fixed
    # signature, and at least sometimes true over a spread of inputs
    hits = 0
    trials = 64
    for i in range(trials):
        sig = spec.bls.Sign(privkeys[i % 16 + 1], i.to_bytes(32, 'little'))
        a = spec.is_sync_committee_aggregator(sig)
        b = spec.is_sync_committee_aggregator(sig)
        assert a == b
        hits += int(a)
    modulo = max(1, int(spec.SYNC_COMMITTEE_SIZE)
                 // int(spec.SYNC_COMMITTEE_SUBNET_COUNT)
                 // int(spec.TARGET_AGGREGATORS_PER_SYNC_SUBCOMMITTEE))
    if modulo == 1:
        assert hits == trials  # everyone aggregates on the minimal shape
    else:
        assert 0 < hits < trials


@with_phases([ALTAIR])
@spec_state_test
def test_compute_subnets_period_boundary_lookahead(spec, state):
    # at the LAST slot of a sync-committee period, subnet duties come from
    # the NEXT committee (validator.md lookahead: next_slot_epoch decides)
    from ...helpers.state import transition_to

    period_epochs = int(spec.EPOCHS_PER_SYNC_COMMITTEE_PERIOD)
    slots_per_epoch = int(spec.SLOTS_PER_EPOCH)
    current_epoch = int(spec.get_current_epoch(state))
    boundary_epoch = (current_epoch // period_epochs + 1) * period_epochs
    transition_to(spec, state, boundary_epoch * slots_per_epoch - 1)

    sub_size = int(spec.SYNC_COMMITTEE_SIZE) // int(spec.SYNC_COMMITTEE_SUBNET_COUNT)
    for index in range(len(state.validators)):
        subnets = spec.compute_subnets_for_sync_committee(state, index)
        pubkey = state.validators[index].pubkey
        expected = {
            spec.uint64(seat // sub_size)
            for seat, pk in enumerate(state.next_sync_committee.pubkeys)
            if pk == pubkey
        }
        assert set(int(s) for s in subnets) == set(int(s) for s in expected)


@with_phases([ALTAIR])
@spec_state_test
@always_bls
def test_sync_committee_message_binds_slot(spec, state):
    # the signing data covers the slot's epoch domain AND the block root:
    # messages for different roots must differ; same (root, epoch) agree
    index = 3
    root_a = spec.Root(b"\x11" * 32)
    root_b = spec.Root(b"\x22" * 32)
    m_same_epoch = spec.get_sync_committee_message(
        state, root_a, index, privkeys[index]
    )
    m_same_epoch2 = spec.get_sync_committee_message(
        state, root_a, index, privkeys[index]
    )
    m_other_root = spec.get_sync_committee_message(
        state, root_b, index, privkeys[index]
    )
    assert m_same_epoch.signature == m_same_epoch2.signature
    assert m_same_epoch.signature != m_other_root.signature
    assert int(m_same_epoch.validator_index) == index
    assert m_same_epoch.slot == state.slot
