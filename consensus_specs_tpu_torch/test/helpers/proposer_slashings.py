"""Proposer-slashing fixtures and effect checks.

Role parity with the reference's
proposer-slashing helper module: build a slashable header pair for a chosen
proposer, run the handler as an (pre, op, post) vector, and audit the
balance/flag effects of a successful slashing
(reference specs/phase0/beacon-chain.md:1760-1781; slash_validator
:1140-1165; altair penalty-quotient override specs/altair/beacon-chain.md:
411-440).
"""
from .block import sign_block_header
from .keys import privkeys

_FILLER_ROOTS = {
    "parent_root": b"\x21" * 32,
    "state_root": b"\x32" * 32,
    "body_root": b"\x43" * 32,
}


def get_min_slashing_penalty_quotient(spec):
    """The penalty quotient active at this fork (altair tightened it;
    merge inherits altair's value in v1.1.3)."""
    altair_q = getattr(spec, "MIN_SLASHING_PENALTY_QUOTIENT_ALTAIR", None)
    if altair_q is not None and spec.fork != "phase0":
        return altair_q
    return spec.MIN_SLASHING_PENALTY_QUOTIENT


def slashable_header_pair(spec, state, proposer, slot, divergence=b"\x99" * 32):
    """Two distinct headers for the same (slot, proposer) — the slashable
    condition — differing only in parent_root."""
    base = spec.BeaconBlockHeader(
        slot=slot, proposer_index=proposer, **_FILLER_ROOTS
    )
    twin = base.copy()
    twin.parent_root = divergence
    return base, twin


def get_valid_proposer_slashing(spec, state, random_root=b"\x99" * 32,
                                slashed_index=None, slot=None,
                                signed_1=False, signed_2=False):
    """A ProposerSlashing against ``slashed_index`` (default: the last
    active validator, so fixture targets stay clear of the proposer duty
    rotation at low indices). Unsigned envelopes are produced when the
    ``signed_*`` flags are off, letting signature-failure cases reuse the
    same builder."""
    if slashed_index is None:
        epoch = spec.get_current_epoch(state)
        slashed_index = spec.get_active_validator_indices(state, epoch)[-1]
    if slot is None:
        slot = state.slot

    h1, h2 = slashable_header_pair(spec, state, slashed_index, slot, random_root)
    sk = privkeys[slashed_index]

    def envelope(header, do_sign):
        if do_sign:
            return sign_block_header(spec, state, header, sk)
        return spec.SignedBeaconBlockHeader(message=header)

    return spec.ProposerSlashing(
        signed_header_1=envelope(h1, signed_1),
        signed_header_2=envelope(h2, signed_2),
    )


def check_proposer_slashing_effect(spec, pre_state, state, slashed_index):
    """Audit every observable consequence of a landed proposer slashing."""
    victim = state.validators[slashed_index]
    assert victim.slashed
    assert victim.exit_epoch < spec.FAR_FUTURE_EPOCH
    assert victim.withdrawable_epoch < spec.FAR_FUTURE_EPOCH

    penalty = victim.effective_balance // get_min_slashing_penalty_quotient(spec)
    reward = victim.effective_balance // spec.WHISTLEBLOWER_REWARD_QUOTIENT
    reporter = spec.get_beacon_proposer_index(state)

    delta_victim = int(state.balances[slashed_index]) - int(pre_state.balances[slashed_index])
    delta_reporter = int(state.balances[reporter]) - int(pre_state.balances[reporter])
    if reporter == slashed_index:
        # self-report: one balance carries both the penalty and the reward
        assert delta_victim == int(reward) - int(penalty)
    else:
        assert delta_victim == -int(penalty)
        assert delta_reporter == int(reward)


def run_proposer_slashing_processing(spec, state, proposer_slashing, valid=True):
    """Drive ``process_proposer_slashing`` as a test vector: yields
    (pre, op, post); an invalid op must assert and yields ``post: None``."""
    from ..context import expect_assertion_error

    snapshot = state.copy()
    yield "pre", state
    yield "proposer_slashing", proposer_slashing

    if not valid:
        expect_assertion_error(
            lambda: spec.process_proposer_slashing(state, proposer_slashing)
        )
        yield "post", None
        return

    spec.process_proposer_slashing(state, proposer_slashing)
    yield "post", state
    check_proposer_slashing_effect(
        spec, snapshot, state,
        proposer_slashing.signed_header_1.message.proposer_index,
    )
