"""upgrade_to_merge fork-transition tests
(spec: reference specs/merge/fork.md:30-85)."""
from ...context import ALTAIR, MERGE, spec_state_test, with_phases
from ...helpers.random import randomize_registry_for_upgrade
from ...helpers.state import next_epoch


def _upgrade(phases, pre_state):
    merge = phases[MERGE]
    post = merge.upgrade_to_merge(pre_state)
    assert post.fork.previous_version == pre_state.fork.current_version
    assert post.fork.current_version == merge.config.MERGE_FORK_VERSION
    assert post.fork.epoch == phases[ALTAIR].get_current_epoch(pre_state)
    assert post.slot == pre_state.slot
    assert list(post.balances) == list(pre_state.balances)
    assert list(post.inactivity_scores) == list(pre_state.inactivity_scores)
    assert post.current_sync_committee == pre_state.current_sync_committee
    assert post.next_sync_committee == pre_state.next_sync_committee
    # the merge starts incomplete: empty payload header
    assert post.latest_execution_payload_header == merge.ExecutionPayloadHeader()
    assert not merge.is_merge_complete(post)
    return post


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_fresh_state(spec, state, phases):
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_after_epochs(spec, state, phases):
    next_epoch(spec, state)
    next_epoch(spec, state)
    # dirty some participation so the carried fields are nontrivial
    state.previous_epoch_participation = [
        spec.ParticipationFlags(i % 8) for i in range(len(state.validators))
    ]
    yield 'pre', state
    post = _upgrade(phases, state)
    assert list(post.previous_epoch_participation) == list(state.previous_epoch_participation)
    yield 'post', post


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_registry(spec, state, phases):
    next_epoch(spec, state)
    randomize_registry_for_upgrade(spec, state, seed=31337)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post
    for pre_v, post_v in zip(state.validators, post.validators):
        assert pre_v.pubkey == post_v.pubkey
        assert pre_v.slashed == post_v.slashed
        assert pre_v.effective_balance == post_v.effective_balance


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_registry_alt_seed(spec, state, phases):
    next_epoch(spec, state)
    next_epoch(spec, state)
    randomize_registry_for_upgrade(spec, state, seed=271828)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_mid_epoch(spec, state, phases):
    from ...helpers.state import next_slot

    next_epoch(spec, state)
    for _ in range(2):
        next_slot(spec, state)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post
    assert post.latest_block_header == state.latest_block_header


# -- randomized pre-state upgrades (role parity with the reference's merge
#    fork random suite) ------------------------------------------------------

from random import Random

from ...helpers.attestations import next_epoch_with_attestations


def _randomized_upgrade(spec, state, phases, seed, with_attestations=False,
                        leaking=False):
    rng = Random(seed)
    next_epoch(spec, state)
    if leaking:
        from ...helpers.state import advance_into_leak

        advance_into_leak(spec, state)
    if with_attestations:
        _, _, state = next_epoch_with_attestations(spec, state, True, True)
    randomize_registry_for_upgrade(spec, state, seed)
    for i in range(0, len(state.validators), 3):
        state.balances[i] = spec.Gwei(
            rng.randrange(int(spec.MAX_EFFECTIVE_BALANCE * 2))
        )
    state.inactivity_scores = [
        spec.uint64(rng.randrange(0, 200)) for _ in range(len(state.validators))
    ]
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_seed_1(spec, state, phases):
    yield from _randomized_upgrade(spec, state, phases, seed=3101)


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_seed_2(spec, state, phases):
    yield from _randomized_upgrade(spec, state, phases, seed=3102)


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_with_attestations_seed_3(spec, state, phases):
    yield from _randomized_upgrade(
        spec, state, phases, seed=3103, with_attestations=True
    )


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_with_attestations_seed_4(spec, state, phases):
    yield from _randomized_upgrade(
        spec, state, phases, seed=3104, with_attestations=True
    )


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_while_leaking(spec, state, phases):
    yield from _randomized_upgrade(spec, state, phases, seed=3105, leaking=True)


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_random_heavy_churn(spec, state, phases):
    rng = Random(3106)
    next_epoch(spec, state)
    cur = spec.get_current_epoch(state)
    for i, v in enumerate(state.validators):
        roll = rng.random()
        if roll < 0.15:
            v.exit_epoch = cur + rng.randrange(1, 6)
        elif roll < 0.25:
            v.slashed = True
            v.exit_epoch = cur
            v.withdrawable_epoch = cur + 12
    yield 'pre', state
    post = _upgrade(phases, state)
    for i in range(len(state.validators)):
        assert post.validators[i].slashed == state.validators[i].slashed
        assert post.validators[i].exit_epoch == state.validators[i].exit_epoch
    yield 'post', post


@with_phases([ALTAIR], other_phases=[MERGE])
@spec_state_test
def test_upgrade_preserves_historical_and_checkpoints(spec, state, phases):
    next_epoch(spec, state)
    next_epoch(spec, state)
    state.finalized_checkpoint.epoch = spec.Epoch(1)
    state.finalized_checkpoint.root = b"\x5c" * 32
    yield 'pre', state
    post = _upgrade(phases, state)
    assert post.finalized_checkpoint == state.finalized_checkpoint
    assert post.current_justified_checkpoint == state.current_justified_checkpoint
    assert list(post.block_roots) == list(state.block_roots)
    assert list(post.historical_roots) == list(state.historical_roots)
    yield 'post', post
