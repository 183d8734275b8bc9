"""Networking-math unit tests: the p2p spec's computable artifacts
(spec: reference specs/phase0/p2p-interface.md:168-291, :887-975;
beacon-chain.md:861-871)."""
from ...context import spec_state_test, with_all_phases


@with_all_phases
@spec_state_test
def test_gossip_message_id_domains(spec, state):
    from ...helpers.forks import is_post_altair

    payload = b"some gossip payload"
    valid_id = spec.compute_gossip_message_id(payload, payload)
    invalid_id = spec.compute_gossip_message_id(payload, None)
    assert len(valid_id) == 20 and len(invalid_id) == 20
    # domain separation: the same bytes id differently by snappy validity
    assert valid_id != invalid_id
    if is_post_altair(spec):
        # altair+ prepends the (empty here) topic length + bytes
        prefix = spec.uint_to_bytes(spec.uint64(0))
    else:
        prefix = b""
    assert valid_id == spec.hash(spec.MESSAGE_DOMAIN_VALID_SNAPPY + prefix + payload)[:20]
    assert invalid_id == spec.hash(spec.MESSAGE_DOMAIN_INVALID_SNAPPY + prefix + payload)[:20]


@with_all_phases
@spec_state_test
def test_fork_digest_binds_genesis_root(spec, state):
    digest = spec.compute_fork_digest(
        state.fork.current_version, state.genesis_validators_root
    )
    assert len(digest) == 4
    other = spec.compute_fork_digest(
        state.fork.current_version, b"\x09" * 32
    )
    assert digest != other  # different chain, different digest


@with_all_phases
@spec_state_test
def test_enr_fork_id_roundtrip(spec, state):
    enr = spec.ENRForkID(
        fork_digest=spec.compute_fork_digest(
            state.fork.current_version, state.genesis_validators_root
        ),
        next_fork_version=state.fork.current_version,
        next_fork_epoch=spec.FAR_FUTURE_EPOCH,
    )
    again = spec.ENRForkID.decode_bytes(enr.encode_bytes())
    assert again == enr


@with_all_phases
@spec_state_test
def test_metadata_shape(spec, state):
    md = spec.MetaData(seq_number=7)
    assert int(md.seq_number) == 7
    assert len(md.attnets) == spec.ATTESTATION_SUBNET_COUNT
    if hasattr(md, "syncnets"):
        # altair+ extends MetaData with the syncnets bitfield
        assert len(md.syncnets) == spec.SYNC_COMMITTEE_SUBNET_COUNT
    assert spec.MetaData.decode_bytes(md.encode_bytes()) == md


@with_all_phases
@spec_state_test
def test_status_message_roundtrip(spec, state):
    status = spec.Status(
        fork_digest=b"\x01\x02\x03\x04",
        finalized_root=b"\x05" * 32,
        finalized_epoch=9,
        head_root=b"\x06" * 32,
        head_slot=300,
    )
    assert spec.Status.decode_bytes(status.encode_bytes()) == status


@with_all_phases
@spec_state_test
def test_altair_message_id_binds_topic(spec, state):
    from ...helpers.forks import is_post_altair

    if not is_post_altair(spec):
        return
    payload = b"payload bytes"
    a = spec.compute_gossip_message_id(payload, payload, topic=b"/eth2/x/beacon_block/ssz_snappy")
    b = spec.compute_gossip_message_id(payload, payload, topic=b"/eth2/x/other_topic/ssz_snappy")
    assert a != b  # same payload, different topic, different id
    want = spec.hash(
        spec.MESSAGE_DOMAIN_VALID_SNAPPY
        + spec.uint_to_bytes(spec.uint64(len(b"/eth2/x/beacon_block/ssz_snappy")))
        + b"/eth2/x/beacon_block/ssz_snappy" + payload
    )[:20]
    assert a == want
