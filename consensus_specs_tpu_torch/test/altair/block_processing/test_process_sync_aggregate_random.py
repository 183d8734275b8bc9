"""Random-participation process_sync_aggregate coverage (role parity with
the reference's sync_aggregate random suite): seeded participation
patterns at several densities, against plain / misc-balance / low-balance /
duplicate-heavy committee states — every case audited seat-by-seat through
run_sync_aggregate_processing's balance reconstruction
(spec: reference specs/altair/beacon-chain.md:535-565)."""
from random import Random

from ...context import (
    ALTAIR,
    low_balances,
    misc_balances,
    spec_state_test,
    spec_test,
    with_custom_state,
    with_phases,
)
from ...helpers.state import transition_to
from ...helpers.sync_committee import build_sync_aggregate, get_committee_indices
from .test_process_sync_aggregate import run_sync_aggregate_processing


def _random_bits(spec, seed, density):
    rng = Random(seed)
    return [
        rng.random() < density for _ in range(int(spec.SYNC_COMMITTEE_SIZE))
    ]


def _run_random_case(spec, state, seed, density):
    transition_to(spec, state, state.slot + 3)
    bits = _random_bits(spec, seed, density)
    agg = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, agg)


@with_phases([ALTAIR])
@spec_state_test
def test_random_participation_high_seed_10(spec, state):
    yield from _run_random_case(spec, state, seed=10, density=0.9)


@with_phases([ALTAIR])
@spec_state_test
def test_random_participation_high_seed_11(spec, state):
    yield from _run_random_case(spec, state, seed=11, density=0.9)


@with_phases([ALTAIR])
@spec_state_test
def test_random_participation_exact_half_seed_20(spec, state):
    yield from _run_random_case(spec, state, seed=20, density=0.5)


@with_phases([ALTAIR])
@spec_state_test
def test_random_participation_exact_half_seed_21(spec, state):
    yield from _run_random_case(spec, state, seed=21, density=0.5)


@with_phases([ALTAIR])
@spec_state_test
def test_random_participation_sparse_seed_30(spec, state):
    yield from _run_random_case(spec, state, seed=30, density=0.12)


@with_phases([ALTAIR])
@spec_state_test
def test_random_participation_sparse_seed_31(spec, state):
    yield from _run_random_case(spec, state, seed=31, density=0.12)


@with_phases([ALTAIR])
@spec_state_test
def test_random_only_one_participant(spec, state):
    rng = Random(40)
    transition_to(spec, state, state.slot + 3)
    bits = [False] * int(spec.SYNC_COMMITTEE_SIZE)
    bits[rng.randrange(len(bits))] = True
    agg = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, agg)


@with_phases([ALTAIR])
@spec_state_test
def test_random_all_but_one_participant(spec, state):
    rng = Random(41)
    transition_to(spec, state, state.slot + 3)
    bits = [True] * int(spec.SYNC_COMMITTEE_SIZE)
    bits[rng.randrange(len(bits))] = False
    agg = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, agg)


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=misc_balances, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_random_with_misc_balances(spec, state):
    yield from _run_random_case(spec, state, seed=50, density=0.6)


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=low_balances, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_random_with_low_balances(spec, state):
    yield from _run_random_case(spec, state, seed=51, density=0.6)


def _tiny_registry(spec):
    # fewer validators than sync-committee seats -> guaranteed duplicates
    return [spec.MAX_EFFECTIVE_BALANCE] * max(
        4, int(spec.SYNC_COMMITTEE_SIZE) // 4
    )


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=_tiny_registry, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_random_duplicate_committee_members_rewarded_per_seat(spec, state):
    """With a small registry the sync committee holds duplicate members;
    a validator occupying k set seats earns k participant rewards (the
    effect audit in the runner is seat-based, so this asserts the spec's
    per-seat accounting)."""
    transition_to(spec, state, state.slot + 3)
    seats = get_committee_indices(spec, state)
    counts = {}
    for s in seats:
        counts[s] = counts.get(s, 0) + 1
    dup = max(counts, key=counts.get)
    assert counts[dup] >= 2, "registry too large for duplicate seats"
    bits = [seats[i] == dup for i in range(len(seats))]
    agg = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, agg)


@with_phases([ALTAIR])
@spec_test
@with_custom_state(balances_fn=_tiny_registry, threshold_fn=lambda spec: spec.config.EJECTION_BALANCE)
def test_random_nonparticipants_pay_while_participants_earn(spec, state):
    """Mixed pattern where the same validator holds both a set and an
    unset seat: net effect = +reward-penalty applied per seat."""
    transition_to(spec, state, state.slot + 3)
    seats = get_committee_indices(spec, state)
    counts = {}
    for s in seats:
        counts[s] = counts.get(s, 0) + 1
    dup = max(counts, key=counts.get)
    assert counts[dup] >= 2
    first = seats.index(dup)
    bits = [False] * len(seats)
    bits[first] = True  # one set seat; the duplicate's other seats stay unset
    agg = build_sync_aggregate(spec, state, bits)
    yield from run_sync_aggregate_processing(spec, state, agg)
