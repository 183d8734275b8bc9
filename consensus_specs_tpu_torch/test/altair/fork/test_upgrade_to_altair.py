"""upgrade_to_altair fork-transition tests
(spec: reference specs/altair/fork.md:40-107; scenario coverage modeled on
the reference's altair/fork suite, written for this harness)."""
from ...context import (
    ALTAIR, PHASE0, spec_state_test, with_phases,
)
from ...helpers.attestations import next_epoch_with_attestations
from ...helpers.random import randomize_registry_for_upgrade
from ...helpers.state import next_epoch


def _upgrade(phases, pre_state):
    altair = phases[ALTAIR]
    post = altair.upgrade_to_altair(pre_state)
    # invariants that must hold for every upgrade
    assert post.fork.previous_version == pre_state.fork.current_version
    assert post.fork.current_version == altair.config.ALTAIR_FORK_VERSION
    assert post.fork.epoch == phases[PHASE0].get_current_epoch(pre_state)
    assert post.genesis_time == pre_state.genesis_time
    assert post.genesis_validators_root == pre_state.genesis_validators_root
    assert post.slot == pre_state.slot
    assert len(post.validators) == len(pre_state.validators)
    assert list(post.balances) == list(pre_state.balances)
    assert list(post.inactivity_scores) == [0] * len(pre_state.validators)
    assert post.current_sync_committee == altair.get_next_sync_committee(post)
    return post


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_fresh_state(spec, state, phases):
    yield 'pre', state
    post = _upgrade(phases, state)
    # no pending attestations -> participation stays empty
    altair = phases[ALTAIR]
    assert list(post.previous_epoch_participation) == (
        [altair.ParticipationFlags(0)] * len(post.validators)
    )
    yield 'post', post


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_after_epochs(spec, state, phases):
    next_epoch(spec, state)
    next_epoch(spec, state)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_translates_participation(spec, state, phases):
    # a full epoch of attestations leaves previous_epoch_attestations
    # populated; the upgrade must translate them into participation flags
    next_epoch(spec, state)  # leave the genesis epoch before back-filling
    state, _, post_state = next_epoch_with_attestations(spec, state, False, True)
    state = post_state
    assert len(state.previous_epoch_attestations) > 0
    yield 'pre', state
    post = _upgrade(phases, state)
    altair = phases[ALTAIR]
    flagged = [
        i for i, flags in enumerate(post.previous_epoch_participation)
        if int(flags) != 0
    ]
    assert len(flagged) > 0
    # every flagged validator attested in the pre-state
    attesters = set()
    for att in state.previous_epoch_attestations:
        attesters |= set(spec.get_attesting_indices(state, att.data, att.aggregation_bits))
    assert set(flagged) <= attesters
    yield 'post', post


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_registry_low(spec, state, phases):
    next_epoch(spec, state)
    randomize_registry_for_upgrade(spec, state, seed=101, include_activation=True)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post
    # registry content carried over field-for-field
    for pre_v, post_v in zip(state.validators, post.validators):
        assert pre_v.pubkey == post_v.pubkey
        assert pre_v.slashed == post_v.slashed
        assert pre_v.exit_epoch == post_v.exit_epoch


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_registry_alt_seed(spec, state, phases):
    next_epoch(spec, state)
    next_epoch(spec, state)
    randomize_registry_for_upgrade(spec, state, seed=202, include_activation=True)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_preserves_finality_and_history(spec, state, phases):
    state, _, post_state = next_epoch_with_attestations(spec, state, True, False)
    state = post_state
    state, _, post_state = next_epoch_with_attestations(spec, state, True, False)
    state = post_state
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post
    assert post.finalized_checkpoint == state.finalized_checkpoint
    assert post.current_justified_checkpoint == state.current_justified_checkpoint
    assert list(post.block_roots) == list(state.block_roots)
    assert list(post.state_roots) == list(state.state_roots)
    assert post.eth1_data == state.eth1_data


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_mid_epoch_slot(spec, state, phases):
    from ...helpers.state import next_slot

    next_epoch(spec, state)
    for _ in range(3):
        next_slot(spec, state)
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post
    assert post.slot == state.slot


# -- randomized pre-state upgrades (role parity with the reference's
#    altair fork random suite: seeded registry/balance/attestation shapes
#    pushed through upgrade_to_altair, invariants checked by _upgrade) ------

from random import Random


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
    # random balances too (registry randomizer touches flags/exits)
    for i in range(0, len(state.validators), 3):
        state.balances[i] = spec.Gwei(rng.randrange(int(spec.MAX_EFFECTIVE_BALANCE * 2)))
    yield 'pre', state
    post = _upgrade(phases, state)
    yield 'post', post
    return post


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_seed_1(spec, state, phases):
    yield from _randomized_upgrade(spec, state, phases, seed=2101)


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_seed_2(spec, state, phases):
    yield from _randomized_upgrade(spec, state, phases, seed=2102)


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_with_attestations_seed_3(spec, state, phases):
    yield from _randomized_upgrade(
        spec, state, phases, seed=2103, with_attestations=True
    )


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_with_attestations_seed_4(spec, state, phases):
    yield from _randomized_upgrade(
        spec, state, phases, seed=2104, with_attestations=True
    )


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_while_leaking(spec, state, phases):
    yield from _randomized_upgrade(spec, state, phases, seed=2105, leaking=True)


@with_phases([PHASE0], other_phases=[ALTAIR])
@spec_state_test
def test_upgrade_random_large_validator_churn(spec, state, phases):
    rng = Random(2106)
    next_epoch(spec, state)
    cur = spec.get_current_epoch(state)
    # heavy churn: a third exited, some slashed, some pending withdrawal
    for i in range(len(state.validators)):
        roll = rng.random()
        v = state.validators[i]
        if roll < 0.2:
            v.exit_epoch = cur + rng.randrange(1, 8)
        elif roll < 0.3:
            v.slashed = True
            v.exit_epoch = cur
            v.withdrawable_epoch = cur + 16
    yield 'pre', state
    post = _upgrade(phases, state)
    # churn flags survive the schema migration untouched
    for i in range(len(state.validators)):
        assert post.validators[i].slashed == state.validators[i].slashed
        assert post.validators[i].exit_epoch == state.validators[i].exit_epoch
    yield 'post', post
