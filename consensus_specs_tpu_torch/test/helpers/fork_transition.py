"""Cross-fork transition drive: run a chain up to a fork epoch, apply the
upgrade function, keep building on the post-fork spec.

Own implementation for this harness; fills the role of the reference's
test/helpers/fork_transition.py (336 LoC). The upgrade is applied exactly
where the spec text requires: after process_slots reaches the first slot of
the fork epoch (reference specs/altair/fork.md:36-38).
"""
from .block import build_empty_block_for_next_slot, sign_block
from .state import state_transition_and_sign_block, transition_to

UPGRADE_FN_BY_FORK = {
    "altair": "upgrade_to_altair",
    "merge": "upgrade_to_merge",
}


def transition_until_fork(spec, state, fork_epoch):
    """Advance to the LAST slot before the fork epoch (pre-fork rules)."""
    fork_slot = fork_epoch * spec.SLOTS_PER_EPOCH
    transition_to(spec, state, fork_slot - 1)
    assert spec.get_current_epoch(state) < fork_epoch


def do_fork(state, spec, post_spec, fork_epoch, with_block=True):
    """Cross the boundary: pre-fork process_slots into the fork epoch,
    apply upgrade_to_*, then (optionally) produce the first post-fork block.
    Returns (post_state, signed_block_or_None)."""
    fork_slot = fork_epoch * spec.SLOTS_PER_EPOCH
    spec.process_slots(state, fork_slot)
    assert spec.get_current_epoch(state) == fork_epoch

    upgrade = getattr(post_spec, UPGRADE_FN_BY_FORK[post_spec.fork])
    state = upgrade(state)
    assert state.fork.epoch == fork_epoch
    assert state.fork.current_version == _fork_version(post_spec)

    if not with_block:
        return state, None
    # first post-fork block: built and signed under the POST spec at the
    # fork slot itself (state has not advanced past it)
    block = post_spec.BeaconBlock(
        slot=state.slot,
        proposer_index=post_spec.get_beacon_proposer_index(state),
        parent_root=_parent_root(post_spec, state),
    )
    if hasattr(block.body, "sync_aggregate"):
        block.body.sync_aggregate.sync_committee_signature = (
            post_spec.G2_POINT_AT_INFINITY
        )
    _apply_randao(post_spec, state, block)
    # the state already sits AT the block slot (the upgrade just ran), so
    # derive the state root from a copy via process_block alone
    temp_state = state.copy()
    post_spec.process_block(temp_state, block)
    block.state_root = post_spec.hash_tree_root(temp_state)
    signed_block = sign_block(post_spec, state, block)
    post_spec.process_block(state, block)
    return state, signed_block


def _fork_version(post_spec):
    return {
        "altair": post_spec.config.ALTAIR_FORK_VERSION,
        "merge": post_spec.config.MERGE_FORK_VERSION,
    }[post_spec.fork]


def _parent_root(spec, state):
    header = state.latest_block_header.copy()
    if header.state_root == spec.Root():
        header.state_root = spec.hash_tree_root(state)
    return spec.hash_tree_root(header)


def _apply_randao(spec, state, block):
    from .keys import privkeys

    proposer = block.proposer_index
    domain = spec.get_domain(
        state, spec.DOMAIN_RANDAO, spec.compute_epoch_at_slot(block.slot)
    )
    signing_root = spec.compute_signing_root(
        spec.compute_epoch_at_slot(block.slot), domain
    )
    block.body.randao_reveal = spec.bls.Sign(privkeys[proposer], signing_root)


def transition_to_next_epoch_and_append_blocks(post_spec, state, blocks):
    """One full post-fork epoch of empty blocks, appended to ``blocks``."""
    for _ in range(int(post_spec.SLOTS_PER_EPOCH)):
        block = build_empty_block_for_next_slot(post_spec, state)
        blocks.append(state_transition_and_sign_block(post_spec, state, block))
    return state
