# Altair — P2P networking interface: the executable artifacts
#
# The computable parts of reference specs/altair/p2p-interface.md: the
# sync-committee subnet helper and the extended MetaData. The gossip
# transport itself is specified, not executed (SURVEY.md §2.7/P5).


class MetaData(Container):
    # (altair/p2p-interface.md — adds the `syncnets` bitfield advertised in
    # the ENR for sync-committee subnet stability)
    seq_number: uint64
    attnets: Bitvector[ATTESTATION_SUBNET_COUNT]
    syncnets: Bitvector[SYNC_COMMITTEE_SUBNET_COUNT]


def compute_gossip_message_id(message_data: bytes, valid_snappy_decompressed: bytes = None,
                              topic: bytes = b'') -> bytes:
    """Altair message-id binds the TOPIC alongside the payload
    (altair/p2p-interface.md:77-89): SHA256(domain + uint64(len(topic)) +
    topic + payload)[:20]. Phase0-digest topics keep the phase0 procedure."""
    if valid_snappy_decompressed is not None:
        return hash(
            MESSAGE_DOMAIN_VALID_SNAPPY + uint_to_bytes(uint64(len(topic)))
            + topic + valid_snappy_decompressed
        )[:20]
    return hash(
        MESSAGE_DOMAIN_INVALID_SNAPPY + uint_to_bytes(uint64(len(topic)))
        + topic + message_data
    )[:20]


def get_sync_subcommittee_pubkeys(state: BeaconState, subcommittee_index: uint64) -> Sequence[BLSPubkey]:
    # (altair/p2p-interface.md:124-138 — gossip-validation convenience)
    # Committees assigned to `slot` sign for `slot - 1`
    # This creates the exceptional logic below when transitioning between sync committee periods
    next_slot_epoch = compute_epoch_at_slot(Slot(state.slot + 1))
    if compute_sync_committee_period(get_current_epoch(state)) == compute_sync_committee_period(next_slot_epoch):
        sync_committee = state.current_sync_committee
    else:
        sync_committee = state.next_sync_committee

    # Return pubkeys for the subcommittee index
    sync_subcommittee_size = SYNC_COMMITTEE_SIZE // SYNC_COMMITTEE_SUBNET_COUNT
    i = subcommittee_index * sync_subcommittee_size
    return sync_committee.pubkeys[i:i + sync_subcommittee_size]
