"""Cross-fork transition tests: chains that live through an upgrade
(machinery: context.fork_transition_test + helpers/fork_transition.py;
reference altair/transition suite + specs/altair/fork.md:36-38,
specs/merge/fork.md)."""
from ...context import ALTAIR, MERGE, PHASE0, fork_transition_test
from ...helpers.block import build_empty_block_for_next_slot
from ...helpers.fork_transition import (
    do_fork, transition_to_next_epoch_and_append_blocks, transition_until_fork,
)
from ...helpers.state import state_transition_and_sign_block


def _run_normal_transition(spec, post_spec, state, fork_epoch):
    yield 'pre', state
    blocks = []
    # pre-fork epochs of empty blocks
    while spec.get_current_epoch(state) < fork_epoch - 1 or (
        (state.slot + 2) % spec.SLOTS_PER_EPOCH != 0
    ):
        block = build_empty_block_for_next_slot(spec, state)
        blocks.append(state_transition_and_sign_block(spec, state, block))
        if state.slot + 1 == fork_epoch * spec.SLOTS_PER_EPOCH:
            break

    pre_validators_root = state.genesis_validators_root
    pre_validator_count = len(state.validators)
    state, fork_block = do_fork(state, spec, post_spec, fork_epoch)
    assert fork_block is not None
    blocks.append(fork_block)
    assert state.fork.current_version == _version(post_spec)
    # identity carried across the upgrade
    assert state.genesis_validators_root == pre_validators_root
    assert len(state.validators) == pre_validator_count

    # a full post-fork epoch keeps transitioning fine
    state = transition_to_next_epoch_and_append_blocks(post_spec, state, blocks)
    assert post_spec.get_current_epoch(state) == fork_epoch + 1
    yield 'blocks', blocks
    yield 'post', state


def _version(post_spec):
    return {
        ALTAIR: post_spec.config.ALTAIR_FORK_VERSION,
        MERGE: post_spec.config.MERGE_FORK_VERSION,
    }[post_spec.fork]


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=2)
def test_normal_transition_to_altair(spec, post_spec, state, fork_epoch, phases):
    yield from _run_normal_transition(spec, post_spec, state, fork_epoch)


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=1)
def test_transition_to_altair_at_epoch_1(spec, post_spec, state, fork_epoch, phases):
    yield from _run_normal_transition(spec, post_spec, state, fork_epoch)


@fork_transition_test(ALTAIR, MERGE, fork_epoch=2)
def test_normal_transition_to_merge(spec, post_spec, state, fork_epoch, phases):
    yield from _run_normal_transition(spec, post_spec, state, fork_epoch)


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=2)
def test_transition_no_block_at_fork_slot(spec, post_spec, state, fork_epoch, phases):
    """The upgrade happens inside process_slots even when the fork slot
    itself is empty (specs/altair/fork.md:36-38)."""
    yield 'pre', state
    transition_until_fork(spec, state, fork_epoch)
    state, fork_block = do_fork(state, spec, post_spec, fork_epoch, with_block=False)
    assert fork_block is None
    assert state.fork.current_version == post_spec.config.ALTAIR_FORK_VERSION
    blocks = []
    state = transition_to_next_epoch_and_append_blocks(post_spec, state, blocks)
    assert post_spec.get_current_epoch(state) == fork_epoch + 1
    yield 'blocks', blocks
    yield 'post', state


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=2)
def test_transition_with_attestations_crossing_fork(spec, post_spec, state, fork_epoch, phases):
    """Attestations from the phase0 side are translated into participation
    flags by the upgrade (specs/altair/fork.md translate_participation)."""
    from ...helpers.attestations import get_valid_attestation

    yield 'pre', state
    blocks = []
    # walk to the last pre-fork slot, carrying attestations through the
    # final pre-fork epoch so they are pending at the upgrade
    fork_slot = int(fork_epoch) * int(spec.SLOTS_PER_EPOCH)
    while int(state.slot) < fork_slot - 1:
        block = build_empty_block_for_next_slot(spec, state)
        if int(state.slot) >= (int(fork_epoch) - 1) * int(spec.SLOTS_PER_EPOCH):
            block.body.attestations = [
                get_valid_attestation(spec, state, slot=state.slot, signed=True)
            ]
        blocks.append(state_transition_and_sign_block(spec, state, block))
    state, fork_block = do_fork(state, spec, post_spec, fork_epoch)
    blocks.append(fork_block)
    # translated flags: at least the attesters carry timely-source credit
    assert any(int(f) != 0 for f in state.previous_epoch_participation)
    state = transition_to_next_epoch_and_append_blocks(post_spec, state, blocks)
    yield 'blocks', blocks
    yield 'post', state


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=2)
def test_transition_with_exit_pending_at_fork(spec, post_spec, state, fork_epoch, phases):
    """An exit initiated pre-fork completes on the post-fork chain."""
    target = len(state.validators) - 1
    state.validators[target].exit_epoch = spec.Epoch(fork_epoch + 1)
    state.validators[target].withdrawable_epoch = spec.Epoch(fork_epoch + 9)
    yield 'pre', state

    transition_until_fork(spec, state, fork_epoch)
    state, fork_block = do_fork(state, spec, post_spec, fork_epoch)
    blocks = [fork_block]
    assert state.validators[target].exit_epoch == fork_epoch + 1
    for _ in range(2):
        state = transition_to_next_epoch_and_append_blocks(post_spec, state, blocks)
    assert not post_spec.is_active_validator(
        state.validators[target], post_spec.get_current_epoch(state)
    )
    yield 'blocks', blocks
    yield 'post', state


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=2)
def test_transition_with_slashed_validator_carried(spec, post_spec, state, fork_epoch, phases):
    state.validators[3].slashed = True
    state.validators[3].exit_epoch = spec.Epoch(fork_epoch)
    state.validators[3].withdrawable_epoch = spec.Epoch(fork_epoch + 20)
    yield 'pre', state
    transition_until_fork(spec, state, fork_epoch)
    state, fork_block = do_fork(state, spec, post_spec, fork_epoch)
    blocks = [fork_block]
    assert state.validators[3].slashed
    state = transition_to_next_epoch_and_append_blocks(post_spec, state, blocks)
    assert state.validators[3].slashed
    yield 'blocks', blocks
    yield 'post', state


@fork_transition_test(ALTAIR, MERGE, fork_epoch=1)
def test_transition_to_merge_at_epoch_1(spec, post_spec, state, fork_epoch, phases):
    yield from _run_normal_transition(spec, post_spec, state, fork_epoch)


@fork_transition_test(PHASE0, ALTAIR, fork_epoch=2)
def test_transition_then_operations_post_fork(spec, post_spec, state, fork_epoch, phases):
    """Post-fork blocks still carry phase0-style operations (an exit)."""
    from ...helpers.voluntary_exits import prepare_signed_exits

    # shrink the exit-eligibility period (the decorator already gave both
    # specs config COPIES) instead of aging hundreds of real blocks
    spec.config.SHARD_COMMITTEE_PERIOD = spec.uint64(2)
    post_spec.config.SHARD_COMMITTEE_PERIOD = post_spec.uint64(2)
    yield 'pre', state
    transition_until_fork(spec, state, fork_epoch)
    state, fork_block = do_fork(state, spec, post_spec, fork_epoch)
    blocks = [fork_block]

    for _ in range(2):
        state = transition_to_next_epoch_and_append_blocks(post_spec, state, blocks)

    exits = prepare_signed_exits(post_spec, state, [len(state.validators) - 2])
    block = build_empty_block_for_next_slot(post_spec, state)
    block.body.voluntary_exits = exits
    blocks.append(state_transition_and_sign_block(post_spec, state, block))
    assert state.validators[len(state.validators) - 2].exit_epoch < post_spec.FAR_FUTURE_EPOCH
    yield 'blocks', blocks
    yield 'post', state
