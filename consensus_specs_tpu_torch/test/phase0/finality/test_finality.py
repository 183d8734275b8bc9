"""Multi-epoch justification/finalization scenarios, written as a
participation schedule table driven through one runner.

Rule coverage parity with the
reference finality suite: all four finalization rules of
``process_justification_and_finalization`` (reference
specs/phase0/beacon-chain.md:1377-1394 — rules keyed on the justification
bitfield and the 1/2/3-epoch distance of the finalizable checkpoint), the
genesis grace period (:1345-1350, no movement before GENESIS_EPOCH + 2),
plus stall/recovery schedules the reference does not exercise.

Schedule alphabet (per epoch): 'c' = include current-epoch attestations,
'p' = previous-epoch, 'b' = both, '-' = none. Expectations are three
movement flags 'CPF' (Current justified / Previous justified / Finalized
advanced this epoch; '.' = unchanged), optionally '+ruleN' asserting WHICH
old checkpoint the epoch finalized.
"""
from ...context import PHASE0, spec_state_test, with_phases
from ...helpers.attestations import next_epoch_with_attestations
from ...helpers.state import next_epoch, next_epoch_via_block

_FILL = {
    "c": (True, False),
    "p": (False, True),
    "b": (True, True),
    "-": (False, False),
}

# which PRE-epoch checkpoint each rule finalizes
_RULE_SOURCE = {
    "rule1": "previous_justified_checkpoint",
    "rule2": "previous_justified_checkpoint",
    "rule3": "current_justified_checkpoint",
    "rule4": "current_justified_checkpoint",
}


def _checkpoint_moved(new_cp, old_cp):
    moved = new_cp.epoch > old_cp.epoch
    if moved:
        assert new_cp.root != old_cp.root
    else:
        assert new_cp == old_cp
    return moved


def _assert_movement(spec, state, before, flags):
    want = [f != "." for f in flags]
    got = [
        _checkpoint_moved(state.current_justified_checkpoint,
                          before.current_justified_checkpoint),
        _checkpoint_moved(state.previous_justified_checkpoint,
                          before.previous_justified_checkpoint),
        _checkpoint_moved(state.finalized_checkpoint,
                          before.finalized_checkpoint),
    ]
    assert got == want, f"movement {got}, schedule expected {want}"


def _play(spec, state, schedule, warmup_epochs=2, warmup_via_blocks=False):
    """Run the participation schedule, asserting each epoch's expected
    checkpoint movements; yields the usual sanity-blocks vector parts."""
    for _ in range(warmup_epochs):
        if warmup_via_blocks:
            next_epoch_via_block(spec, state)
        else:
            next_epoch(spec, state)

    yield "pre", state

    blocks = []
    for entry in schedule:
        pattern, _, expect = entry.partition(":")
        flags, _, rule = expect.partition("+")
        fill_cur, fill_prev = _FILL[pattern]
        before, new_blocks, state = next_epoch_with_attestations(
            spec, state, fill_cur, fill_prev
        )
        blocks += new_blocks
        _assert_movement(spec, state, before, flags)
        if rule:
            source = getattr(before, _RULE_SOURCE[rule])
            assert state.finalized_checkpoint == source, (
                f"{rule}: finalized {state.finalized_checkpoint}, "
                f"expected pre-epoch {_RULE_SOURCE[rule]} {source}"
            )

    yield "blocks", blocks
    yield "post", state


@with_phases([PHASE0])
@spec_state_test
def test_finality_no_updates_at_genesis(spec, state):
    # the first two epochs are the grace period: full participation moves
    # nothing (justification starts at GENESIS_EPOCH + 2)
    assert spec.get_current_epoch(state) == spec.GENESIS_EPOCH
    yield from _play(spec, state, ["c:...", "c:..."], warmup_epochs=0)


@with_phases([PHASE0])
@spec_state_test
def test_finality_rule_4(spec, state):
    # same-epoch votes two epochs running: the second epoch finalizes the
    # checkpoint justified one epoch earlier (the fast path)
    yield from _play(spec, state, ["c:C..", "c:CPF+rule4"])


@with_phases([PHASE0])
@spec_state_test
def test_finality_rule_1(spec, state):
    # votes always one epoch late: justification trails by one, and the
    # third epoch finalizes the checkpoint from two epochs back
    yield from _play(
        spec, state,
        ["p:C..", "p:CP.", "p:CPF+rule1"],
        warmup_via_blocks=True,  # distinct boundary roots for late votes
    )


@with_phases([PHASE0])
@spec_state_test
def test_finality_rule_2(spec, state):
    # justify, stall one epoch, then late votes finalize the two-epoch-old
    # previous-justified checkpoint
    yield from _play(spec, state, ["c:C..", "-:.P.", "p:C.F+rule2"])


@with_phases([PHASE0])
@spec_state_test
def test_finality_rule_3(spec, state):
    # the ethereum/consensus-specs#611 shape: justified chain, a silent
    # epoch, a late-vote catch-up, then a both-epochs burst whose
    # previous-epoch votes re-justify and finalize the OLD current
    # checkpoint at distance two
    yield from _play(
        spec, state,
        ["c:C..", "c:CPF+rule4", "-:.P.", "p:C.F+rule2", "b:CPF+rule3"],
    )


@with_phases([PHASE0])
@spec_state_test
def test_finality_stall_without_quorum_then_recover(spec, state):
    # original scenario: after a justification, TWO silent epochs push the
    # justified checkpoint out of finalization range — late votes then
    # re-justify but must NOT finalize (distance > 2); a both-votes epoch
    # afterwards resumes finalization via rule 3
    yield from _play(
        spec, state,
        ["c:C..", "-:.P.", "-:...", "p:C..", "b:CPF+rule3"],
    )


@with_phases([PHASE0])
@spec_state_test
def test_finality_full_participation_streak(spec, state):
    # original scenario: sustained full participation finalizes every epoch
    # after the pipeline fills — each epoch is a fresh rule-4 instance, so
    # the finalized head tracks exactly one epoch behind justification
    yield from _play(
        spec, state,
        ["c:C..", "c:CPF+rule4", "c:CPF+rule4", "c:CPF+rule4"],
    )
