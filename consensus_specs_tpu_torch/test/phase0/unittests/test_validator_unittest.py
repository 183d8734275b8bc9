"""Honest-validator duty unit tests
(spec: reference specs/phase0/validator.md; scenario coverage modeled on
the reference's phase0/unittests/validator/test_validator_unittest.py,
written for this harness)."""
from ...context import always_bls, spec_state_test, with_all_phases
from ...helpers.attestations import get_valid_attestation
from ...helpers.block import build_empty_block
from ...helpers.keys import privkeys, pubkeys
from ...helpers.state import next_epoch


@with_all_phases
@spec_state_test
def test_check_if_validator_active(spec, state):
    active = spec.check_if_validator_active(state, 0)
    assert active  # genesis validators are active
    # deactivate one
    state.validators[1].exit_epoch = spec.get_current_epoch(state)
    assert not spec.check_if_validator_active(state, 1)


@with_all_phases
@spec_state_test
def test_get_committee_assignment_current_epoch(spec, state):
    epoch = spec.get_current_epoch(state)
    seen = set()
    for index in spec.get_active_validator_indices(state, epoch):
        assignment = spec.get_committee_assignment(state, epoch, index)
        assert assignment is not None
        committee, committee_index, slot = assignment
        assert index in committee
        assert spec.compute_epoch_at_slot(slot) == epoch
        assert committee_index < spec.get_committee_count_per_slot(state, epoch)
        seen.add(int(index))
    # every active validator is assigned exactly once per epoch
    assert seen == set(int(i) for i in spec.get_active_validator_indices(state, epoch))


@with_all_phases
@spec_state_test
def test_get_committee_assignment_next_epoch_only(spec, state):
    # querying beyond next epoch must fail
    from ...context import expect_assertion_error

    next_epoch_num = spec.get_current_epoch(state) + 2
    expect_assertion_error(
        lambda: spec.get_committee_assignment(state, next_epoch_num, 0)
    )


@with_all_phases
@spec_state_test
def test_is_proposer(spec, state):
    proposer = spec.get_beacon_proposer_index(state)
    assert spec.is_proposer(state, proposer)
    others = [i for i in range(len(state.validators)) if i != proposer]
    assert not spec.is_proposer(state, others[0])


@with_all_phases
@spec_state_test
@always_bls
def test_get_epoch_signature_matches_randao_domain(spec, state):
    block = build_empty_block(spec, state)
    proposer_index = spec.get_beacon_proposer_index(state)
    privkey = privkeys[proposer_index]
    signature = spec.get_epoch_signature(state, block, privkey)
    domain = spec.get_domain(
        state, spec.DOMAIN_RANDAO, spec.compute_epoch_at_slot(block.slot)
    )
    signing_root = spec.compute_signing_root(
        spec.compute_epoch_at_slot(block.slot), domain
    )
    assert spec.bls.Verify(pubkeys[proposer_index], signing_root, signature)


@with_all_phases
@spec_state_test
def test_compute_subnet_for_attestation_stable(spec, state):
    committees_per_slot = spec.get_committee_count_per_slot(
        state, spec.get_current_epoch(state)
    )
    seen = set()
    for slot in range(int(spec.SLOTS_PER_EPOCH)):
        for index in range(int(committees_per_slot)):
            subnet = spec.compute_subnet_for_attestation(
                committees_per_slot, spec.Slot(slot), spec.CommitteeIndex(index)
            )
            assert 0 <= int(subnet) < spec.ATTESTATION_SUBNET_COUNT
            seen.add(int(subnet))
    # distinct (slot, committee) pairs spread over subnets
    assert len(seen) == min(
        int(spec.SLOTS_PER_EPOCH * committees_per_slot),
        int(spec.ATTESTATION_SUBNET_COUNT),
    )


@with_all_phases
@spec_state_test
@always_bls
def test_aggregator_selection_is_deterministic(spec, state):
    slot = state.slot
    committee_index = spec.CommitteeIndex(0)
    any_aggregator = False
    committee = spec.get_beacon_committee(state, slot, committee_index)
    for index in committee:
        sig = spec.get_slot_signature(state, slot, privkeys[index])
        a = spec.is_aggregator(state, slot, committee_index, sig)
        b = spec.is_aggregator(state, slot, committee_index, sig)
        assert a == b
        any_aggregator |= a
    # with modulo = max(1, len//16) and minimal committees, someone aggregates
    assert any_aggregator


@with_all_phases
@spec_state_test
@always_bls
def test_get_aggregate_and_proof_signature_verifies(spec, state):
    next_epoch(spec, state)
    attestation = get_valid_attestation(
        spec, state, slot=state.slot - 1, signed=True
    )
    aggregator_index = spec.get_attesting_indices(
        state, attestation.data, attestation.aggregation_bits
    ).pop()
    privkey = privkeys[aggregator_index]
    aap = spec.get_aggregate_and_proof(state, aggregator_index, attestation, privkey)
    assert aap.aggregator_index == aggregator_index
    assert aap.aggregate == attestation
    signature = spec.get_aggregate_and_proof_signature(state, aap, privkey)
    domain = spec.get_domain(
        state, spec.DOMAIN_AGGREGATE_AND_PROOF,
        spec.compute_epoch_at_slot(attestation.data.slot),
    )
    signing_root = spec.compute_signing_root(aap, domain)
    assert spec.bls.Verify(pubkeys[aggregator_index], signing_root, signature)


@with_all_phases
@spec_state_test
def test_get_eth1_vote_default_and_majority(spec, state):
    follow_window = int(
        spec.config.SECONDS_PER_ETH1_BLOCK * spec.config.ETH1_FOLLOW_DISTANCE
    )
    # genesis_time of 0 puts the whole follow window before the epoch;
    # shift it so candidate blocks can exist
    state.genesis_time = 3 * follow_window
    period_start = spec.voting_period_start_time(state)
    # no candidate blocks: default vote is the state's own eth1_data
    assert spec.get_eth1_vote(state, []) == state.eth1_data

    follow = int(spec.config.SECONDS_PER_ETH1_BLOCK * spec.config.ETH1_FOLLOW_DISTANCE)
    blocks = [
        spec.Eth1Block(
            timestamp=max(0, int(period_start) - follow - i),
            deposit_root=bytes([i]) * 32,
            deposit_count=state.eth1_data.deposit_count,
        )
        for i in range(1, 4)
    ]
    vote = spec.get_eth1_vote(state, blocks)
    # with no prior votes, the default is the latest candidate in range
    candidates = [
        spec.get_eth1_data(b) for b in blocks
        if spec.is_candidate_block(b, period_start)
    ]
    assert vote == candidates[-1]


@with_all_phases
@spec_state_test
def test_is_candidate_block_window(spec, state):
    follow = int(spec.config.SECONDS_PER_ETH1_BLOCK) * int(spec.config.ETH1_FOLLOW_DISTANCE)
    # a nonzero genesis time so the lookback window doesn't clamp at zero
    state.genesis_time = spec.uint64(10 * follow)
    period_start = spec.voting_period_start_time(state)
    assert int(period_start) >= 2 * follow

    def block_at(ts):
        return spec.Eth1Block(timestamp=spec.uint64(max(0, ts)),
                              deposit_count=1, deposit_root=b'\x22' * 32)

    # inside the [2*follow, follow] lookback window
    assert spec.is_candidate_block(block_at(int(period_start) - follow), period_start)
    assert spec.is_candidate_block(block_at(int(period_start) - 2 * follow), period_start)
    # too recent / too old
    assert not spec.is_candidate_block(block_at(int(period_start) - follow + 1), period_start)
    assert not spec.is_candidate_block(block_at(int(period_start) - 2 * follow - 1), period_start)


@with_all_phases
@spec_state_test
def test_compute_new_state_root_matches_transition(spec, state):
    block = build_empty_block(spec, state, slot=state.slot + 1)
    root = spec.compute_new_state_root(state, block)
    post = state.copy()
    spec.process_slots(post, block.slot)
    spec.process_block(post, block)
    assert root == spec.hash_tree_root(post)


@with_all_phases
@spec_state_test
@always_bls
def test_get_block_signature_verifies(spec, state):
    block = build_empty_block(spec, state, slot=state.slot + 1)
    tmp = state.copy()
    spec.process_slots(tmp, block.slot)
    proposer_index = spec.get_beacon_proposer_index(tmp)
    signature = spec.get_block_signature(state, block, privkeys[proposer_index])
    domain = spec.get_domain(
        state, spec.DOMAIN_BEACON_PROPOSER, spec.compute_epoch_at_slot(block.slot)
    )
    signing_root = spec.compute_signing_root(block, domain)
    assert spec.bls.Verify(pubkeys[proposer_index], signing_root, signature)


@with_all_phases
@spec_state_test
@always_bls
def test_get_slot_signature_verifies(spec, state):
    slot = state.slot
    signature = spec.get_slot_signature(state, slot, privkeys[7])
    domain = spec.get_domain(
        state, spec.DOMAIN_SELECTION_PROOF, spec.compute_epoch_at_slot(slot)
    )
    signing_root = spec.compute_signing_root(slot, domain)
    assert spec.bls.Verify(pubkeys[7], signing_root, signature)


@with_all_phases
@spec_state_test
@always_bls
def test_get_attestation_signature_verifies(spec, state):
    attestation = get_valid_attestation(spec, state, signed=False)
    participant = spec.get_beacon_committee(
        state, attestation.data.slot, attestation.data.index
    )[0]
    signature = spec.get_attestation_signature(
        state, attestation.data, privkeys[participant]
    )
    domain = spec.get_domain(
        state, spec.DOMAIN_BEACON_ATTESTER, attestation.data.target.epoch
    )
    signing_root = spec.compute_signing_root(attestation.data, domain)
    assert spec.bls.Verify(pubkeys[participant], signing_root, signature)


@with_all_phases
@spec_state_test
def test_compute_fork_digest_distinct_per_version(spec, state):
    digest_a = spec.compute_fork_digest(
        spec.Version(b'\x00\x00\x00\x00'), state.genesis_validators_root
    )
    digest_b = spec.compute_fork_digest(
        spec.Version(b'\x01\x00\x00\x00'), state.genesis_validators_root
    )
    assert digest_a != digest_b
    # deterministic
    assert digest_a == spec.compute_fork_digest(
        spec.Version(b'\x00\x00\x00\x00'), state.genesis_validators_root
    )


@with_all_phases
@spec_state_test
def test_get_committee_assignment_out_of_bound_epoch(spec, state):
    from ...context import expect_assertion_error

    epoch = spec.get_current_epoch(state) + 2  # beyond the 1-epoch lookahead
    expect_assertion_error(
        lambda: spec.get_committee_assignment(state, epoch, spec.ValidatorIndex(0))
    )


@with_all_phases
@spec_state_test
def test_eth1_vote_ignores_noncandidate_chain(spec, state):
    period_start = spec.voting_period_start_time(state)
    follow = int(spec.config.SECONDS_PER_ETH1_BLOCK) * int(spec.config.ETH1_FOLLOW_DISTANCE)
    # every block too recent: default vote (state.eth1_data)
    chain = [
        spec.Eth1Block(timestamp=spec.uint64(int(period_start)),
                       deposit_count=5, deposit_root=b'\x01' * 32)
    ]
    vote = spec.get_eth1_vote(state, chain)
    assert vote == state.eth1_data


# -- eth1 vote edge shapes, aggregation pipeline, and
#    signature-domain separation ------------------------------------------


@with_all_phases
@spec_state_test
def test_get_eth1_vote_tie_prefers_earliest(spec, state):
    # a tie between two vote candidates resolves by list order (max with a
    # count key keeps the first maximal element)
    cfg = spec.config
    follow_window = int(cfg.SECONDS_PER_ETH1_BLOCK * cfg.ETH1_FOLLOW_DISTANCE)
    state.genesis_time = 3 * follow_window  # make the candidate window reachable
    period_start = spec.voting_period_start_time(state)
    blocks = []
    for i, ts_back in enumerate((follow_window * 2,
                                 follow_window + follow_window // 2)):
        blocks.append(spec.Eth1Block(
            timestamp=period_start - ts_back,
            deposit_root=bytes([10 + i]) * 32,
            deposit_count=state.eth1_data.deposit_count,
        ))
    votes = []
    for b in blocks:  # one vote each: a genuine tie between two candidates
        assert spec.is_candidate_block(b, period_start)
        votes.append(spec.Eth1Data(
            block_hash=spec.hash_tree_root(b),
            deposit_root=b.deposit_root,
            deposit_count=b.deposit_count,
        ))
    state.eth1_data_votes = votes
    vote = spec.get_eth1_vote(state, blocks)
    assert vote == votes[0]  # first maximal element wins the tie


@with_all_phases
@spec_state_test
def test_get_eth1_vote_chain_entirely_in_past(spec, state):
    # every known eth1 block is older than the voting window: fall back to
    # the default vote (state.eth1_data)
    cfg = spec.config
    follow_window = int(cfg.SECONDS_PER_ETH1_BLOCK * cfg.ETH1_FOLLOW_DISTANCE)
    state.genesis_time = 10 * follow_window
    period_start = spec.voting_period_start_time(state)
    ancient = spec.Eth1Block(
        timestamp=max(0, int(period_start) - follow_window * 8),
        deposit_root=b"\x77" * 32,
        deposit_count=state.eth1_data.deposit_count,
    )
    state.eth1_data_votes = []
    vote = spec.get_eth1_vote(state, [ancient])
    assert vote == state.eth1_data or vote.deposit_count == state.eth1_data.deposit_count


@with_all_phases
@spec_state_test
@always_bls
def test_get_aggregate_and_proof_roundtrip(spec, state):
    # aggregator builds AggregateAndProof; the selection proof must verify
    # under DOMAIN_SELECTION_PROOF and the envelope under DOMAIN_AGGREGATE_AND_PROOF
    attestation = get_valid_attestation(spec, state, signed=True)
    slot = attestation.data.slot
    committee = spec.get_beacon_committee(state, slot, attestation.data.index)
    aggregator = committee[0]
    privkey = privkeys[aggregator]
    aap = spec.get_aggregate_and_proof(state, aggregator, attestation, privkey)
    assert aap.aggregator_index == aggregator
    assert aap.aggregate == attestation
    # selection proof binds the slot
    domain = spec.get_domain(state, spec.DOMAIN_SELECTION_PROOF, spec.compute_epoch_at_slot(slot))
    signing_root = spec.compute_signing_root(spec.Slot(slot), domain)
    assert spec.bls.Verify(pubkeys[aggregator], signing_root, aap.selection_proof)
    # envelope signature
    sig = spec.get_aggregate_and_proof_signature(state, aap, privkey)
    domain2 = spec.get_domain(state, spec.DOMAIN_AGGREGATE_AND_PROOF, spec.compute_epoch_at_slot(slot))
    signing_root2 = spec.compute_signing_root(aap, domain2)
    assert spec.bls.Verify(pubkeys[aggregator], signing_root2, sig)


@with_all_phases
@spec_state_test
@always_bls
def test_signature_domains_are_disjoint(spec, state):
    # the same message signed under different duty domains must never
    # cross-verify — the domain-separation property every duty relies on
    sk = privkeys[0]
    pk = pubkeys[0]
    epoch = spec.get_current_epoch(state)
    msg = spec.Epoch(epoch)
    domains = [
        spec.get_domain(state, d, epoch)
        for d in (spec.DOMAIN_RANDAO, spec.DOMAIN_SELECTION_PROOF, spec.DOMAIN_BEACON_ATTESTER)
    ]
    sigs = [spec.bls.Sign(sk, spec.compute_signing_root(msg, d)) for d in domains]
    for i, d in enumerate(domains):
        for j, s in enumerate(sigs):
            ok = spec.bls.Verify(pk, spec.compute_signing_root(msg, d), s)
            assert ok == (i == j)


@with_all_phases
@spec_state_test
def test_compute_subnet_spreads_committees(spec, state):
    # distinct (slot, committee) pairs land on distinct subnets within one
    # slot's committee range
    epoch = spec.get_current_epoch(state)
    committees = int(spec.get_committee_count_per_slot(state, epoch))
    slot = state.slot
    subnets = {
        int(spec.compute_subnet_for_attestation(committees, slot, idx))
        for idx in range(committees)
    }
    assert len(subnets) == committees


@with_all_phases
@spec_state_test
def test_is_aggregator_threshold_boundary(spec, state):
    # a committee smaller than TARGET_AGGREGATORS_PER_COMMITTEE makes the
    # modulo 1 -> everyone aggregates regardless of signature
    slot = state.slot
    committee = spec.get_beacon_committee(state, slot, 0)
    if len(committee) <= spec.TARGET_AGGREGATORS_PER_COMMITTEE:
        sig = spec.bls.Sign(privkeys[committee[0]], b"\x11" * 32)
        assert spec.is_aggregator(state, slot, 0, sig)
    else:
        modulo = len(committee) // int(spec.TARGET_AGGREGATORS_PER_COMMITTEE)
        assert modulo >= 1
