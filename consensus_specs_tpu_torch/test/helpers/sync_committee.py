"""Sync-committee test helpers (altair+).

Own design for this framework's harness; fills the role of the reference's
test/helpers/sync_committee.py (aggregate-signature construction :27-45) and
its reward arithmetic helpers.
"""
from .keys import privkeys


def compute_sync_committee_signing_root(spec, state, slot):
    """Signing root a sync committee signs at ``slot``: the block root of the
    previous slot under DOMAIN_SYNC_COMMITTEE
    (reference specs/altair/beacon-chain.md:540-545)."""
    previous_slot = max(int(slot), 1) - 1
    domain = spec.get_domain(
        state, spec.DOMAIN_SYNC_COMMITTEE, spec.compute_epoch_at_slot(previous_slot)
    )
    if previous_slot == int(state.slot):
        # the block at previous_slot is not part of state history yet; tests
        # signing for the *current* head use the latest header root
        header = state.latest_block_header.copy()
        if header.state_root == spec.Root():
            header.state_root = spec.hash_tree_root(state)
        block_root = spec.hash_tree_root(header)
    else:
        block_root = spec.get_block_root_at_slot(state, previous_slot)
    return spec.compute_signing_root(spec.Root(block_root), domain)


def compute_aggregate_sync_committee_signature(spec, state, slot, participants,
                                               block_root=None):
    """Aggregate signature of ``participants`` (validator indices) over the
    sync-committee message of ``slot``."""
    if len(participants) == 0:
        return spec.G2_POINT_AT_INFINITY
    if block_root is not None:
        previous_slot = max(int(slot), 1) - 1
        domain = spec.get_domain(
            state, spec.DOMAIN_SYNC_COMMITTEE, spec.compute_epoch_at_slot(previous_slot)
        )
        signing_root = spec.compute_signing_root(spec.Root(block_root), domain)
    else:
        signing_root = compute_sync_committee_signing_root(spec, state, slot)
    return spec.bls.Aggregate([
        spec.bls.Sign(privkeys[index], signing_root) for index in participants
    ])


def build_sync_aggregate(spec, state, participation_bits, slot=None, block_root=None):
    """A SyncAggregate with the given per-seat participation bits, signed by
    the corresponding current-sync-committee members."""
    if slot is None:
        slot = state.slot
    committee_indices = get_committee_indices(spec, state)
    participants = [
        committee_indices[i] for i, bit in enumerate(participation_bits) if bit
    ]
    signature = compute_aggregate_sync_committee_signature(
        spec, state, slot, participants, block_root=block_root
    )
    return spec.SyncAggregate(
        sync_committee_bits=participation_bits,
        sync_committee_signature=signature,
    )


def get_committee_indices(spec, state):
    """Validator indices of the current sync committee, seat by seat (with
    duplicates preserved)."""
    all_pubkeys = [v.pubkey for v in state.validators]
    return [
        all_pubkeys.index(pk) for pk in state.current_sync_committee.pubkeys
    ]


def compute_sync_committee_participant_reward_and_penalty(spec, state):
    """(per-seat participant reward, proposer reward-per-participating-seat)
    mirroring process_sync_aggregate's arithmetic
    (reference specs/altair/beacon-chain.md:546-551)."""
    total_active_increments = (
        spec.get_total_active_balance(state) // spec.EFFECTIVE_BALANCE_INCREMENT
    )
    total_base_rewards = spec.get_base_reward_per_increment(state) * total_active_increments
    max_participant_rewards = (
        total_base_rewards * spec.SYNC_REWARD_WEIGHT
        // spec.WEIGHT_DENOMINATOR // spec.SLOTS_PER_EPOCH
    )
    participant_reward = max_participant_rewards // spec.SYNC_COMMITTEE_SIZE
    proposer_reward = (
        participant_reward * spec.PROPOSER_WEIGHT
        // (spec.WEIGHT_DENOMINATOR - spec.PROPOSER_WEIGHT)
    )
    return participant_reward, proposer_reward
