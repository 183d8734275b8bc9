# Sharding (draft) — P2P interface, computable parts (executable spec source)
#
# Provenance: transcribed from the draft spec text (reference
# specs/sharding/p2p-interface.md:32-78). Only the pure functions/constants
# are executable — gossip validation conditions are protocol prose (the
# same policy the phase0 p2p source follows).

SHARD_BLOB_SUBNET_COUNT = 64
SHARD_TX_PROPAGATION_GRACE_SLOTS = 4
SHARD_TX_PROPAGATION_BUFFER_SLOTS = 8


def compute_subnet_for_shard_blob(state: BeaconState, slot: Slot, shard: Shard) -> uint64:
    """
    Compute the correct subnet for a shard blob publication.
    Note, this mimics compute_subnet_for_attestation().
    """
    committee_index = compute_committee_index_from_shard(state, slot, shard)
    committees_per_slot = get_committee_count_per_slot(state, compute_epoch_at_slot(slot))
    slots_since_epoch_start = Slot(slot % SLOTS_PER_EPOCH)
    committees_since_epoch_start = committees_per_slot * slots_since_epoch_start

    return uint64((committees_since_epoch_start + committee_index) % SHARD_BLOB_SUBNET_COUNT)
