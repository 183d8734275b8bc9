"""Block-construction helpers for the test harness.

Role parity with the reference's
block helper module (reference test/helpers/block.py): produce empty blocks
wired to a state (parent root, proposer, randao reveal), sign them with the
deterministic key schedule, and run unsigned transitions.

Design: slot-forwarding is centralized in ``_state_at_slot`` — every
consumer that needs slot-N data (proposer lookup, parent root, payload
wiring) works on ONE forwarded copy instead of re-deriving it, and the
caller's state is never advanced implicitly.
"""
from .forks import is_post_altair, is_post_sharding
from .keys import privkeys


def _state_at_slot(spec, state, slot):
    """A state whose slot is exactly ``slot``: the original object when
    already there, else a forwarded COPY (the caller's state is untouched).
    Building for past slots is a harness bug — fail loudly."""
    if slot < state.slot:
        raise ValueError(
            f"cannot derive block data for past slot {slot} (state at {state.slot})"
        )
    if slot == state.slot:
        return state
    fwd = state.copy()
    spec.process_slots(fwd, slot)
    return fwd


def _proposer_for(spec, state, slot, proposer_index=None):
    """Proposer index at ``slot``, honoring an explicit override (used by
    invalid-proposer test cases)."""
    if proposer_index is not None:
        return proposer_index
    return spec.get_beacon_proposer_index(_state_at_slot(spec, state, slot))


def _parent_root(spec, at_slot_state):
    """Root of the latest block header as the chain would see it: a header
    whose state_root is still the placeholder gets it patched in first
    (process_slot does the same before hashing, reference
    specs/phase0/beacon-chain.md:1271-1282)."""
    header = at_slot_state.latest_block_header.copy()
    if header.state_root == spec.Root():
        header.state_root = spec.hash_tree_root(at_slot_state)
    return spec.hash_tree_root(header)


def _epoch_signing_root(spec, state, obj, domain_type, slot):
    domain = spec.get_domain(state, domain_type, spec.compute_epoch_at_slot(slot))
    return spec.compute_signing_root(obj, domain)


def apply_randao_reveal(spec, state, block, proposer_index=None):
    """Install the proposer's randao reveal (an epoch signature, reference
    specs/phase0/beacon-chain.md:1719-1729) into ``block``."""
    assert state.slot <= block.slot
    proposer = _proposer_for(spec, state, block.slot, proposer_index)
    epoch = spec.compute_epoch_at_slot(block.slot)
    root = _epoch_signing_root(spec, state, epoch, spec.DOMAIN_RANDAO, block.slot)
    block.body.randao_reveal = spec.bls.Sign(privkeys[proposer], root)


def sign_block(spec, state, block, proposer_index=None):
    """Wrap ``block`` in a SignedBeaconBlock carrying the proposer's
    signature (reference specs/phase0/beacon-chain.md:1253-1258)."""
    proposer = _proposer_for(spec, state, block.slot, proposer_index)
    root = _epoch_signing_root(
        spec, state, block, spec.DOMAIN_BEACON_PROPOSER, block.slot
    )
    return spec.SignedBeaconBlock(
        message=block, signature=spec.bls.Sign(privkeys[proposer], root)
    )


def sign_block_header(spec, state, header, privkey):
    """Signed header for proposer-slashing fixtures."""
    root = _epoch_signing_root(
        spec, state, header, spec.DOMAIN_BEACON_PROPOSER, header.slot
    )
    return spec.SignedBeaconBlockHeader(
        message=header, signature=spec.bls.Sign(privkey, root)
    )


def transition_unsigned_block(spec, state, block):
    """Advance ``state`` to the block's slot and run process_block only —
    no signature checks (for fixtures built before signing)."""
    if state.slot < block.slot:
        spec.process_slots(state, block.slot)
    assert state.slot == block.slot, "block is not for the state's slot"
    assert state.latest_block_header.slot < block.slot, (
        "a block at or past this slot was already applied"
    )
    spec.process_block(state, block)
    return block


def build_empty_block(spec, state, slot=None):
    """A minimal valid block for ``slot``: correct parent root, proposer,
    eth1 deposit-count echo, randao reveal — and per-fork extras (altair's
    infinity-signature empty sync aggregate per specs/altair/bls.md:59-68;
    sharding's mandatory execution payload per sharding/beacon-chain.md:545)."""
    if slot is None:
        slot = state.slot
    at_slot = _state_at_slot(spec, state, slot)

    block = spec.BeaconBlock(
        slot=slot,
        proposer_index=spec.get_beacon_proposer_index(at_slot),
        parent_root=_parent_root(spec, at_slot),
    )
    block.body.eth1_data.deposit_count = at_slot.eth1_deposit_index

    if is_post_altair(spec):
        # zero participation must carry the infinity signature, not the
        # all-zero default (eth_fast_aggregate_verify's special case)
        block.body.sync_aggregate.sync_committee_signature = (
            spec.G2_POINT_AT_INFINITY
        )
    if is_post_sharding(spec):
        from .execution_payload import build_empty_execution_payload

        block.body.execution_payload = build_empty_execution_payload(spec, at_slot)

    apply_randao_reveal(spec, at_slot, block)
    return block


def build_empty_block_for_next_slot(spec, state):
    return build_empty_block(spec, state, state.slot + 1)


def apply_empty_block(spec, state, slot=None):
    """Advance ``state`` by applying a freshly built empty signed block."""
    from .state import state_transition_and_sign_block

    return state_transition_and_sign_block(
        spec, state, build_empty_block(spec, state, slot)
    )
