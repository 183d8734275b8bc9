"""process_registry_updates scenarios, driven by a snapshot-diff machinery.

Own structure for this harness (same behavioral surface the reference's
epoch_processing suite pins down, different scenario machinery): each test
shapes the registry with the `_deposited`/`_drained` mutators, runs the
single sub-pass through the shared vector runner, and asserts on a
before/after `RegistryView` diff instead of poking validator fields
inline. The spec under test: eligibility marking, finality-gated
activation dequeue ordering, churn limiting on both queues, and ejection
of drained validators (specsrc/phase0/beacon_chain.py
process_registry_updates).
"""
from ...context import (
    MINIMAL,
    scaled_churn_balances,
    spec_state_test,
    spec_test,
    with_all_phases,
    with_custom_state,
    with_presets,
    default_activation_threshold,
)
from ...helpers.epoch_processing import run_epoch_processing_with
from ...helpers.state import next_epoch, next_slots


# -- scenario machinery ------------------------------------------------------


class RegistryView:
    """Frozen (eligibility, activation, exit) epochs for a set of indices;
    ``diff`` against a later view names exactly which lifecycle fields the
    pass touched."""

    def __init__(self, spec, state, indices):
        self.indices = list(indices)
        self.far = spec.FAR_FUTURE_EPOCH
        self.rows = {
            i: (
                state.validators[i].activation_eligibility_epoch,
                state.validators[i].activation_epoch,
                state.validators[i].exit_epoch,
            )
            for i in self.indices
        }

    def newly_eligible(self, other):
        return [i for i in self.indices
                if self.rows[i][0] == self.far and other.rows[i][0] != self.far]

    def newly_activated(self, other):
        return [i for i in self.indices
                if self.rows[i][1] == self.far and other.rows[i][1] != self.far]

    def newly_exiting(self, other):
        return [i for i in self.indices
                if self.rows[i][2] == self.far and other.rows[i][2] != self.far]

    def untouched(self, other):
        return [i for i in self.indices if self.rows[i] == other.rows[i]]


def _deposited(spec, state, index, *, balance=None, eligibility=None):
    """Shape validator ``index`` like a fresh deposit: lifecycle epochs
    cleared to FAR_FUTURE, effective balance at the activation threshold
    unless a scenario lowers it; returns the index for chaining."""
    v = state.validators[index]
    v.activation_eligibility_epoch = spec.FAR_FUTURE_EPOCH
    v.activation_epoch = spec.FAR_FUTURE_EPOCH
    v.effective_balance = spec.MAX_EFFECTIVE_BALANCE if balance is None else balance
    if eligibility is not None:
        v.activation_eligibility_epoch = eligibility
    assert not spec.is_active_validator(v, spec.get_current_epoch(state))
    return index


def _drained(spec, state, index):
    """Shape validator ``index`` for ejection (balance at the floor)."""
    state.validators[index].effective_balance = spec.config.EJECTION_BALANCE
    return index


def _queue_since(spec, state, indices, epoch):
    """Pin the whole batch's eligibility to ``epoch`` (already past the
    marking step, waiting on the finality-gated dequeue)."""
    for i in indices:
        state.validators[i].activation_eligibility_epoch = epoch
    return list(indices)


def _finalize(spec, state, lag=1):
    """Fake finality ``lag`` epochs back — what the dequeue gate reads."""
    state.finalized_checkpoint.epoch = spec.get_current_epoch(state) - lag


def _skip_genesis_finality_window(spec, state, epochs=2):
    """The first epochs after genesis have irregular finality; scenarios
    that reason about the dequeue gate start past them."""
    for _ in range(epochs):
        next_epoch(spec, state)


def _run_pass(spec, state, watch):
    """Vector-yielding driver: snapshot ``watch`` indices, run the
    registry sub-pass, return (before, after) views. Usable with
    ``yield from`` thanks to generator return values."""
    before = RegistryView(spec, state, watch)
    yield from run_epoch_processing_with(spec, state, 'process_registry_updates')
    return before, RegistryView(spec, state, watch)


def _exit_spread(spec, state, indices):
    """{exit_epoch: count} over ``indices`` — the churn-spread shape."""
    spread = {}
    for i in indices:
        e = int(state.validators[i].exit_epoch)
        spread[e] = spread.get(e, 0) + 1
    return spread


# -- queue entry -------------------------------------------------------------


@with_all_phases
@spec_state_test
def test_add_to_activation_queue(spec, state):
    _skip_genesis_finality_window(spec, state)
    idx = _deposited(spec, state, 0)

    before, after = yield from _run_pass(spec, state, [idx])

    # marked eligible this pass; activation itself waits on finality
    assert after.rows[idx][0] != spec.FAR_FUTURE_EPOCH
    assert [idx] == before.newly_eligible(after)
    assert not before.newly_activated(after)
    assert not spec.is_active_validator(
        state.validators[idx], spec.get_current_epoch(state)
    )


@with_all_phases
@spec_state_test
def test_no_eligibility_without_full_balance(spec, state):
    shy = spec.MAX_EFFECTIVE_BALANCE - spec.EFFECTIVE_BALANCE_INCREMENT
    idx = _deposited(spec, state, 3, balance=shy)

    before, after = yield from _run_pass(spec, state, [idx])

    # one increment short of the threshold: the marking step ignores it
    assert [idx] == before.untouched(after)


# -- finality-gated dequeue --------------------------------------------------


@with_all_phases
@spec_state_test
def test_activation_queue_to_activated_if_finalized(spec, state):
    _skip_genesis_finality_window(spec, state)
    _finalize(spec, state, lag=1)
    idx = _deposited(spec, state, 0, eligibility=state.finalized_checkpoint.epoch)

    before, after = yield from _run_pass(spec, state, [idx])

    # queued since (at latest) the finalized epoch: dequeued this pass,
    # active once the activation-exit delay elapses
    assert [idx] == before.newly_activated(after)
    assert spec.is_active_validator(
        state.validators[idx],
        spec.compute_activation_exit_epoch(spec.get_current_epoch(state)),
    )


@with_all_phases
@spec_state_test
def test_activation_queue_no_activation_no_finality(spec, state):
    _skip_genesis_finality_window(spec, state)
    _finalize(spec, state, lag=1)
    # eligibility one epoch past what finality covers: must stay queued
    idx = _deposited(
        spec, state, 0, eligibility=state.finalized_checkpoint.epoch + 1
    )

    before, after = yield from _run_pass(spec, state, [idx])

    assert not before.newly_activated(after)
    assert after.rows[idx][0] != spec.FAR_FUTURE_EPOCH  # still marked eligible


@with_all_phases
@spec_state_test
def test_activation_queue_sorting(spec, state):
    churn = int(spec.get_validator_churn_limit(state))
    epoch = spec.get_current_epoch(state)

    # twice the churn limit queued at epoch+1 — except the LAST candidate,
    # which gets the older (higher-priority) eligibility epoch
    batch = [_deposited(spec, state, i) for i in range(churn * 2)]
    _queue_since(spec, state, batch, epoch + 1)
    state.validators[batch[-1]].activation_eligibility_epoch = epoch

    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 3)
    state.finalized_checkpoint.epoch = epoch + 1

    before, after = yield from _run_pass(spec, state, batch)

    dequeued = set(before.newly_activated(after))
    # the eligibility-epoch sort put the prioritized last index in FIRST —
    # it cleared the queue during the epoch advances, before the recorded
    # pass; the pass then fills churn seats in index order
    assert after.rows[batch[-1]][1] != spec.FAR_FUTURE_EPOCH
    assert batch[-1] not in dequeued
    assert batch[0] in dequeued
    assert batch[-2] not in dequeued  # tail of the tied group missed churn
    assert batch[churn - 1] in dequeued
    assert batch[churn] not in dequeued  # one seat went to the priority index


@with_all_phases
@spec_state_test
def test_activation_queue_efficiency_min(spec, state):
    churn = int(spec.get_validator_churn_limit(state))
    epoch = spec.get_current_epoch(state)
    batch = _queue_since(
        spec, state,
        [_deposited(spec, state, i) for i in range(churn * 2)],
        epoch + 1,
    )
    next_slots(spec, state, spec.SLOTS_PER_EPOCH * 3)
    state.finalized_checkpoint.epoch = epoch + 1

    # pass 1 (not part of the vector): drains one churn's worth under the
    # churn limit as it stands after the deposits shrank the active set
    churn_0 = int(spec.get_validator_churn_limit(state))
    first = RegistryView(spec, state, batch)
    spec.process_registry_updates(state)
    mid = RegistryView(spec, state, batch)
    assert first.newly_activated(mid) == batch[:churn_0]

    # pass 2 (the vector): drains the rest
    churn_1 = int(spec.get_validator_churn_limit(state))
    before, after = yield from _run_pass(spec, state, batch)
    assert before.newly_activated(after) == batch[churn_0:churn_0 + churn_1]
    assert len(mid.newly_activated(after)) + churn_0 == churn_0 + churn_1


# -- ejection ----------------------------------------------------------------


@with_all_phases
@spec_state_test
def test_ejection(spec, state):
    idx = _drained(spec, state, 0)
    current = spec.get_current_epoch(state)
    assert spec.is_active_validator(state.validators[idx], current)

    before, after = yield from _run_pass(spec, state, [idx])

    # exit initiated: still active now, gone once the exit delay elapses
    assert [idx] == before.newly_exiting(after)
    assert spec.is_active_validator(state.validators[idx], current)
    assert not spec.is_active_validator(
        state.validators[idx], spec.compute_activation_exit_epoch(current)
    )


@with_all_phases
@spec_state_test
def test_ejection_past_churn_limit(spec, state):
    churn = int(spec.get_validator_churn_limit(state))
    drained = [_drained(spec, state, i) for i in range(churn * 2 + 1)]

    before, after = yield from _run_pass(spec, state, drained)

    # every drained validator starts exiting immediately...
    assert before.newly_exiting(after) == drained
    # ...but the assigned exit epochs spread so no epoch exceeds churn
    spread = _exit_spread(spec, state, drained)
    assert len(spread) > 1
    assert max(spread.values()) <= churn


@with_all_phases
@spec_state_test
def test_already_exited_not_ejected_again(spec, state):
    pinned_exit = spec.get_current_epoch(state) + 5
    state.validators[4].exit_epoch = pinned_exit
    idx = _drained(spec, state, 4)

    before, after = yield from _run_pass(spec, state, [idx])

    # initiate_validator_exit must not reschedule an exit already underway
    assert [idx] == before.untouched(after)
    assert state.validators[idx].exit_epoch == pinned_exit


@with_all_phases
@spec_state_test
def test_activation_and_ejection_in_one_pass(spec, state):
    joining = _deposited(spec, state, 1)
    leaving = _drained(spec, state, 2)

    before, after = yield from _run_pass(spec, state, [joining, leaving])

    assert [joining] == before.newly_eligible(after)
    assert [leaving] == before.newly_exiting(after)


# -- combined churn-boundary scenarios, default AND scaled-churn registries --


def _mixed_churn_scenario(spec, state, extra):
    """churn_limit + extra pending activations AND drained validators in
    one pass: activations honor the churn cap, ejections all initiate but
    their exit epochs spread under it."""
    _skip_genesis_finality_window(spec, state)
    _finalize(spec, state, lag=1)
    n = int(spec.get_validator_churn_limit(state)) + extra
    to_join = _queue_since(
        spec, state,
        [_deposited(spec, state, i) for i in range(n)],
        spec.get_current_epoch(state) - 2,
    )
    to_leave = [
        _drained(spec, state, i)
        for i in range(len(state.validators) - n, len(state.validators))
    ]
    # the deposits above deactivated validators, so the pass may run under
    # a reduced live churn limit — expectations read the live value
    churn = int(spec.get_validator_churn_limit(state))

    before, after = yield from _run_pass(spec, state, to_join + to_leave)

    assert len(before.newly_activated(after)) == min(n, churn)
    assert before.newly_exiting(after) == to_leave
    assert max(_exit_spread(spec, state, to_leave).values()) <= churn


@with_all_phases
@spec_state_test
def test_activation_and_ejection_at_churn_limit(spec, state):
    yield from _mixed_churn_scenario(spec, state, extra=0)


@with_all_phases
@spec_state_test
def test_activation_and_ejection_one_over_churn(spec, state):
    yield from _mixed_churn_scenario(spec, state, extra=1)


@with_all_phases
@with_presets([MINIMAL], reason="mainnet-scale scaled-churn registry exceeds the key pool")
@spec_test
@with_custom_state(scaled_churn_balances, default_activation_threshold)
def test_activation_and_ejection_at_scaled_churn_limit(spec, state):
    assert int(spec.get_validator_churn_limit(state)) > int(
        spec.config.MIN_PER_EPOCH_CHURN_LIMIT
    )
    yield from _mixed_churn_scenario(spec, state, extra=0)


@with_all_phases
@with_presets([MINIMAL], reason="mainnet-scale scaled-churn registry exceeds the key pool")
@spec_test
@with_custom_state(scaled_churn_balances, default_activation_threshold)
def test_activation_and_ejection_over_scaled_churn_limit(spec, state):
    yield from _mixed_churn_scenario(spec, state, extra=2)


@with_all_phases
@with_presets([MINIMAL], reason="mainnet-scale scaled-churn registry exceeds the key pool")
@spec_test
@with_custom_state(scaled_churn_balances, default_activation_threshold)
def test_activation_queue_efficiency_scaled(spec, state):
    # two passes drain a 2x-churn queue end to end at the scaled limit
    _skip_genesis_finality_window(spec, state)
    _finalize(spec, state, lag=1)
    churn = int(spec.get_validator_churn_limit(state))
    queued = _queue_since(
        spec, state,
        [_deposited(spec, state, i) for i in range(churn * 2)],
        spec.get_current_epoch(state) - 2,
    )
    spec.process_registry_updates(state)
    next_epoch(spec, state)
    _finalize(spec, state, lag=1)

    before, after = yield from _run_pass(spec, state, queued)

    activated = [
        i for i in queued
        if state.validators[i].activation_epoch != spec.FAR_FUTURE_EPOCH
    ]
    assert activated == queued
    assert before.newly_activated(after)  # the second pass did real work


@with_all_phases
@with_presets([MINIMAL], reason="mainnet-scale scaled-churn registry exceeds the key pool")
@spec_test
@with_custom_state(scaled_churn_balances, default_activation_threshold)
def test_ejection_past_churn_limit_scaled(spec, state):
    _skip_genesis_finality_window(spec, state)
    churn = int(spec.get_validator_churn_limit(state))
    drained = [_drained(spec, state, i) for i in range(churn + 3)]

    before, after = yield from _run_pass(spec, state, drained)

    assert before.newly_exiting(after) == drained
    assert max(_exit_spread(spec, state, drained).values()) <= churn
