"""process_justification_and_finalization suite (phase0 pending-attestation
form).

Each scenario plants a hand-built justification history (bitfield +
checkpoint pair), seeds exactly-enough or one-short-of-enough target
votes for the epoch being justified, and checks which Casper FFG
finality rule fires. The k2/k3/k12/k23/k234 rule names follow the spec's
four finalization conditions (process_justification_and_finalization,
reference specs/phase0/beacon-chain.md:1389-1433). Scenario coverage
mirrors the reference epoch-processing suite; the vote-seeding machinery
and assertions are this repo's own.
"""
from ...context import PHASE0, spec_state_test, with_phases
from ...helpers.epoch_processing import run_epoch_processing_with
from ...helpers.state import transition_to

# one distinct root per epochs-ago distance, so assertion failures name
# the checkpoint that moved
_ROOTS = {1: b"\xaa", 2: b"\xbb", 3: b"\xcc", 4: b"\xdd", 5: b"\xee"}


def checkpoint_at(spec, epoch, ago):
    """The mocked checkpoint ``ago`` epochs before ``epoch``."""
    assert epoch >= ago
    return spec.Checkpoint(epoch=epoch - ago, root=_ROOTS[ago] * 32)


def plant_history(spec, state, epoch, justified_bits, previous_ago, current_ago):
    """Position the state one slot before ``epoch`` with a mocked FFG
    history: block-root cells for every mock checkpoint, the two justified
    checkpoints at the given distances, and the justification bitfield."""
    transition_to(spec, state, spec.SLOTS_PER_EPOCH * epoch - 1)
    span = spec.SLOTS_PER_HISTORICAL_ROOT
    for ago in _ROOTS:
        if ago <= epoch:
            cp = checkpoint_at(spec, epoch, ago)
            cell = spec.compute_start_slot_at_epoch(cp.epoch) % span
            state.block_roots[cell] = cp.root
    state.previous_justified_checkpoint = checkpoint_at(spec, epoch, previous_ago)
    state.current_justified_checkpoint = checkpoint_at(spec, epoch, current_ago)
    state.justification_bits = spec.Bitvector[spec.JUSTIFICATION_BITS_LENGTH]()
    for bit in justified_bits:
        state.justification_bits[bit] = 1


def seed_epoch_votes(spec, state, epoch, source, target, enough=True,
                     corrupt_target=False):
    """Append PendingAttestations voting (source -> target) for ``epoch``
    until just over 2/3 of the active balance supports it; with
    ``enough=False`` the first voter of every committee abstains, leaving
    support marginally short. ``corrupt_target`` mis-roots every target so
    the votes never match."""
    current = spec.get_current_epoch(state)
    if epoch == current:
        pool = state.current_epoch_attestations
    else:
        assert epoch == spec.get_previous_epoch(state)
        pool = state.previous_epoch_attestations

    budget = int(spec.get_total_active_balance(state)) * 2 // 3
    first = spec.compute_start_slot_at_epoch(epoch)
    for slot in range(first, first + spec.SLOTS_PER_EPOCH):
        for ci in range(spec.get_committee_count_per_slot(state, epoch)):
            if budget < 0:
                return
            members = spec.get_beacon_committee(state, slot, ci)
            quorum = len(members) * 2 // 3 + 1
            bits = [False] * len(members)
            for pos in range(quorum):
                if budget <= 0:
                    break
                bits[pos] = True
                budget -= int(state.validators[members[pos]].effective_balance)
            if not enough and any(bits):
                bits[bits.index(True)] = False
            data = spec.AttestationData(
                slot=slot,
                index=ci,
                beacon_block_root=b"\xff" * 32,
                source=source,
                target=spec.Checkpoint(epoch=target.epoch, root=b"\x99" * 32)
                if corrupt_target
                else target,
            )
            pool.append(
                spec.PendingAttestation(
                    aggregation_bits=bits, data=data, inclusion_delay=1
                )
            )


def run_and_check(spec, state, expect_justified_ago, expect_finalized_ago,
                  epoch, justified):
    """Drive the handler and pin the post-state checkpoints by distance
    (``None`` finalized-ago means the pre-handler value must survive)."""
    old_current = state.current_justified_checkpoint
    old_finalized = state.finalized_checkpoint
    yield from run_epoch_processing_with(
        spec, state, "process_justification_and_finalization"
    )
    # previous_justified always rolls forward to the old current
    assert state.previous_justified_checkpoint == old_current
    if justified:
        assert state.current_justified_checkpoint == checkpoint_at(
            spec, epoch, expect_justified_ago
        )
    else:
        assert state.current_justified_checkpoint == old_current
    if expect_finalized_ago is None:
        assert state.finalized_checkpoint == old_finalized
    else:
        assert state.finalized_checkpoint == checkpoint_at(
            spec, epoch, expect_finalized_ago
        )


def rule_234(spec, state, epoch, enough):
    """Finality rule 1: bits 1..3 set after shift (4th/3rd ago justified,
    2nd justifying now) finalize the 4-epochs-ago source."""
    plant_history(spec, state, epoch, justified_bits=[1, 2],
                  previous_ago=4, current_ago=3)
    seed_epoch_votes(
        spec, state, epoch - 2,
        source=checkpoint_at(spec, epoch, 4),
        target=checkpoint_at(spec, epoch, 2),
        enough=enough,
    )
    yield from run_and_check(
        spec, state, expect_justified_ago=2,
        expect_finalized_ago=4 if enough else None,
        epoch=epoch, justified=enough,
    )


def rule_23(spec, state, epoch, enough):
    """Finality rule 2: 3rd-ago justified, 2nd justifying from it."""
    plant_history(spec, state, epoch, justified_bits=[1],
                  previous_ago=3, current_ago=3)
    seed_epoch_votes(
        spec, state, epoch - 2,
        source=checkpoint_at(spec, epoch, 3),
        target=checkpoint_at(spec, epoch, 2),
        enough=enough,
    )
    yield from run_and_check(
        spec, state, expect_justified_ago=2,
        expect_finalized_ago=3 if enough else None,
        epoch=epoch, justified=enough,
    )


def rule_12(spec, state, epoch, enough, corrupt_target=False):
    """Finality rule 4: 2nd-ago justified, 1st justifying from it."""
    plant_history(spec, state, epoch, justified_bits=[0],
                  previous_ago=2, current_ago=2)
    seed_epoch_votes(
        spec, state, epoch - 1,
        source=checkpoint_at(spec, epoch, 2),
        target=checkpoint_at(spec, epoch, 1),
        enough=enough,
        corrupt_target=corrupt_target,
    )
    landed = enough and not corrupt_target
    yield from run_and_check(
        spec, state, expect_justified_ago=1,
        expect_finalized_ago=2 if landed else None,
        epoch=epoch, justified=landed,
    )


def rule_123(spec, state, epoch, enough):
    """Finality rule 3 with a deep history: previous AND current epochs
    both justify in one pass (previous sourced 5 epochs back), finalizing
    the old current checkpoint at distance 2."""
    plant_history(spec, state, epoch, justified_bits=[1],
                  previous_ago=5, current_ago=3)
    seed_epoch_votes(
        spec, state, epoch - 2,
        source=checkpoint_at(spec, epoch, 5),
        target=checkpoint_at(spec, epoch, 2),
        enough=enough,
    )
    seed_epoch_votes(
        spec, state, epoch - 1,
        source=checkpoint_at(spec, epoch, 3),
        target=checkpoint_at(spec, epoch, 1),
        enough=enough,
    )
    yield from run_and_check(
        spec, state, expect_justified_ago=1,
        expect_finalized_ago=3 if enough else None,
        epoch=epoch, justified=enough,
    )


@with_phases([PHASE0])
@spec_state_test
def test_234_ok_support(spec, state):
    yield from rule_234(spec, state, 5, True)


@with_phases([PHASE0])
@spec_state_test
def test_234_poor_support(spec, state):
    yield from rule_234(spec, state, 5, False)


@with_phases([PHASE0])
@spec_state_test
def test_23_ok_support(spec, state):
    yield from rule_23(spec, state, 4, True)


@with_phases([PHASE0])
@spec_state_test
def test_23_poor_support(spec, state):
    yield from rule_23(spec, state, 4, False)


@with_phases([PHASE0])
@spec_state_test
def test_12_ok_support(spec, state):
    yield from rule_12(spec, state, 3, True)


@with_phases([PHASE0])
@spec_state_test
def test_12_ok_support_messed_target(spec, state):
    yield from rule_12(spec, state, 3, True, corrupt_target=True)


@with_phases([PHASE0])
@spec_state_test
def test_12_poor_support(spec, state):
    yield from rule_12(spec, state, 3, False)


@with_phases([PHASE0])
@spec_state_test
def test_123_ok_support(spec, state):
    yield from rule_123(spec, state, 6, True)


@with_phases([PHASE0])
@spec_state_test
def test_123_poor_support(spec, state):
    yield from rule_123(spec, state, 6, False)


@with_phases([PHASE0])
@spec_state_test
def test_justify_current_without_finality(spec, state):
    """A fresh justification with NO justified history behind it: the
    current epoch's bit lands but no finality rule can fire — finalized
    must stay at genesis."""
    epoch = 3
    plant_history(spec, state, epoch, justified_bits=[],
                  previous_ago=2, current_ago=2)
    seed_epoch_votes(
        spec, state, epoch - 1,
        source=checkpoint_at(spec, epoch, 2),
        target=checkpoint_at(spec, epoch, 1),
    )
    yield from run_and_check(
        spec, state, expect_justified_ago=1, expect_finalized_ago=None,
        epoch=epoch, justified=True,
    )
    assert state.justification_bits[0]


@with_phases([PHASE0])
@spec_state_test
def test_balance_threshold_with_exited_validators(spec, state):
    """Exited-but-unslashed validators shrink BOTH sides of the 2/3
    arithmetic consistently: with a stripe of the registry exited as of
    the previous epoch, the remaining live votes still justify."""
    epoch = 4
    plant_history(spec, state, epoch, justified_bits=[],
                  previous_ago=2, current_ago=2)
    prev = spec.get_previous_epoch(state)
    for i in range(0, len(state.validators), 6):
        v = state.validators[i]
        v.exit_epoch = prev
        v.withdrawable_epoch = prev + 8
    seed_epoch_votes(
        spec, state, epoch - 1,
        source=checkpoint_at(spec, epoch, 2),
        target=checkpoint_at(spec, epoch, 1),
    )
    yield from run_epoch_processing_with(
        spec, state, "process_justification_and_finalization"
    )
    assert state.current_justified_checkpoint == checkpoint_at(spec, epoch, 1)
